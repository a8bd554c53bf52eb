"""Data parallel in the port (``odtk_tpu_torch/parallel/``) against the
JAX package: the world-2 train step over gloo against ``jax.grad`` of
the JAX loss on the whole batch and against the port's own world-1 step,
the batch guards, and the loader's shards.
"""

import os
import subprocess
import sys
import threading
import warnings
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from odtk_tpu.data import DataIterator as JaxIterator
from odtk_tpu.model import Model as JaxModel
from odtk_tpu.parallel import host_local_batch_size as jax_host_local_batch
from odtk_tpu.parallel import make_mesh_for_batch
from odtk_tpu_torch import parallel
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch.data import DataIterator
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops import snap_to_anchors

from synth import make_dataset
from torch_ranks import free_port
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES, SIZE, LR, WD = 3, 128, 0.01, 1e-4

# one global batch of 4, two rows a rank: rank 0's images hold a ~40 px
# box each (P3's anchors) and an ~80 px one (P4's); rank 1's only ~80 px
# boxes, so P3 has foreground on rank 0 and none on rank 1, and the
# ranks' counts differ on P4 too; P5-P7 have none anywhere
TARGETS = [
    [[8, 8, 48, 48, 0], [40, 32, 120, 112, 1]],
    [[64, 64, 104, 104, 2], [10, 70, 50, 110, 0], [60, 8, 140, 88, 2]],
    [[16, 16, 96, 96, 1]],
    [[30, 40, 110, 120, 2]],
]


def _batch():
    rng = np.random.RandomState(12)
    images = rng.randn(4, SIZE, SIZE, 3).astype(np.float32)
    targets = np.full((4, 4, 5), -1, np.float32)
    for i, boxes in enumerate(TARGETS):
        targets[i, :len(boxes)] = boxes
    return images, targets


@pytest.fixture(scope='module')
def variables():
    """ResNet18FPN (3 classes) JAX variables, the frozen batch-norm
    statistics drawn by numpy so that their scale is not 1."""
    v = jax.tree.map(np.asarray, JaxModel('ResNet18FPN', classes=CLASSES)
                     .initialize(rng=0, image_size=(SIZE, SIZE)))
    rng = np.random.RandomState(8)

    def draw(path, leaf):
        if path[-1].key in ('var', 'scale'):
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    v['frozen'] = jax.tree_util.tree_map_with_path(draw, v['frozen'])
    return v


def _fg_per_level(model, targets):
    """Foreground anchors of each level, as ``Model.loss_fn`` assigns."""
    counts = []
    for stride in (8, 16, 32, 64, 128):
        _, _, depth = snap_to_anchors(
            torch.from_numpy(targets), (SIZE, SIZE), stride,
            model.anchor_tensor(stride, 'cpu'), CLASSES, model.anchor_ious)
        counts.append(int((depth > 0).sum()))
    return counts


def _world2_step(tmp_path, state_dict, images, targets):
    """Two gloo processes, one step each on two rows (``torch_ranks``)."""
    torch.save({'state_dict': state_dict, 'images': torch.from_numpy(images),
                'targets': torch.from_numpy(targets), 'classes': CLASSES,
                'lr': LR, 'weight_decay': WD}, tmp_path / 'inputs.pt')
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, 'tests', 'torch_ranks.py'),
         str(rank), '2', str(port), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [torch.load(tmp_path / f'rank{r}.pt') for r in range(2)]


def test_world2_step_equals_the_global_batch(tmp_path, variables):
    """One step at world 2 over gloo (``parallel`` and
    ``make_train_step``; rank 1 starts from other weights, which rank 0's
    broadcast replaces), two rows a rank whose foreground counts differ,
    P3's being 0 on rank 1. (a) The reduced gradients against ``jax.grad``
    of the JAX ``Model.loss_fn`` on the whole batch of 4, at
    ``test_torch_train.py::test_loss_fn_and_gradients_match_jax``'s
    tolerances: both losses at rtol 1e-4, every gradient within 1e-3 of
    its largest entry. (b) Both losses, the gradients and the parameters
    after the step against the port's world-1 step on the batch of 4,
    within a relative 1e-5 (each tensor against its largest entry): the
    sums in another order."""
    images, targets = _batch()
    ref = Model('ResNet18FPN', classes=CLASSES)
    fg0, fg1 = _fg_per_level(ref, targets[:2]), _fg_per_level(ref, targets[2:])
    assert fg0[0] > 0 and fg1[0] == 0 and fg0 != fg1 and fg1[1] > 0, (fg0,
                                                                       fg1)

    state_dict = state_dict_from_jax(variables)
    ranks = _world2_step(tmp_path, state_dict, images, targets)
    assert ranks[0]['loss'] == ranks[1]['loss']
    assert ranks[0]['skipped'] == ranks[1]['skipped'] == 0
    for key in ('grads', 'params'):
        for name, t in ranks[0][key].items():
            assert torch.equal(t, ranks[1][key][name]), (key, name)
    got = ranks[0]

    jmodel = JaxModel('ResNet18FPN', classes=CLASSES)

    def f(p):
        cl, bl = jmodel.loss_fn({'params': p, 'frozen': variables['frozen']},
                                images, targets)
        return cl + bl, (cl, bl)

    (_, (w_cl, w_bl)), w_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables['params'])
    np.testing.assert_allclose(got['loss'], [float(w_cl), float(w_bl)],
                               rtol=1e-4)
    want = state_dict_from_jax({'params': w_g,
                                'frozen': variables['frozen']})
    _assert_close(got['grads'], {k: want[k] for k in got['grads']}, 1e-3)

    model = Model('ResNet18FPN', classes=CLASSES)
    model.module.load_state_dict(state_dict, strict=True)
    opt = port_train.make_optimizer(model.module.parameters(), LR, WD)
    cl, bl = port_train.make_train_step(model, opt, feed='f32')(
        LR, torch.from_numpy(images), torch.from_numpy(targets))
    np.testing.assert_allclose(got['loss'], [cl.item(), bl.item()],
                               rtol=1e-5)
    named = dict(model.module.named_parameters())
    _assert_close(got['grads'], {k: p.grad for k, p in named.items()}, 1e-5)
    _assert_close(got['params'], {k: p.detach() for k, p in named.items()},
                  1e-5)


def _assert_close(got, want, rel):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


def _jax_guard(global_batch, hosts, local_devices):
    with mock.patch.object(jax, 'process_count', return_value=hosts), \
            mock.patch.object(jax, 'local_devices',
                              return_value=[object()] * local_devices):
        try:
            return jax_host_local_batch(global_batch)
        except RuntimeError as e:
            return str(e)


@pytest.mark.parametrize('global_batch,hosts,local_devices', [
    (8, 1, 1), (3, 1, 1), (8, 4, 2), (6, 4, 2), (16, 2, 8), (4, 2, 8)])
def test_host_local_batch_size_matches_jax(global_batch, hosts,
                                           local_devices):
    """``tests/test_parallel.py``'s cases: the per-host batch, or the
    startup error with the JAX package's text."""
    want = _jax_guard(global_batch, hosts, local_devices)
    try:
        got = parallel.host_local_batch_size(global_batch, hosts,
                                             local_devices)
    except RuntimeError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize('local_batch', [8, 6, 7, 3])
def test_processes_for_batch_matches_the_mesh(local_batch):
    """One host with 8 cards: as many processes as ``make_mesh_for_batch``
    has devices on 8 virtual ones, with the same warning."""
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter('always')
        want = make_mesh_for_batch(local_batch).devices.size
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter('always')
        got = parallel.processes_for_batch(local_batch, 8)
    assert got == want
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert parallel.processes_for_batch(local_batch, 8, hosts=2) == 8


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp('shards')), n_images=7,
                        size=(64, 96), fmt='jpg')


@pytest.mark.parametrize('world', [2, 3])
@pytest.mark.parametrize('training', [True, False])
def test_loader_shards_match_jax(dataset, world, training):
    """Each rank's images of an epoch and its batch count: the port's
    loader and the JAX package's, same dataset, seed and epoch (7 images,
    so the last shard wraps round)."""
    img, ann = dataset
    for rank in range(world):
        its = [cls(img, 64, 96, 2 * world, 128, world, ann,
                   training=training, rank=rank)
               for cls in (DataIterator, JaxIterator)]
        for epoch in (0, 3):
            for it in its:
                it.epoch = epoch
            got, want = (it._shard_indices() for it in its)
            assert got == want and len(got) == -(-7 // world)
        assert len(its[0]) == len(its[1])


@pytest.mark.parametrize('on_device_feed', [False, True])
def test_epoch_left_early_stops_the_loader(dataset, on_device_feed):
    """An epoch left after one batch (as ``train`` leaves its last one):
    once the generator is closed none of the loader's workers runs on,
    so none draws from the global ``random`` after the caller seeds it
    again (the next run's init and augmentation)."""
    img, ann = dataset
    before = set(threading.enumerate())
    it = DataIterator(img, 64, 96, 2, 128, 1, ann, training=True,
                      num_threads=2, prefetch=1, emit='u8')
    epoch = (port_train._device_feed(it, torch.device('cpu'))
             if on_device_feed else iter(it))
    next(epoch)
    assert set(threading.enumerate()) - before
    epoch.close()
    assert set(threading.enumerate()) - before == set()


def test_no_group_is_world_one():
    """Without a group: (0, 1), and the gather is the identity."""
    assert not parallel.grouped()
    assert parallel.world_info() == (0, 1)
    x = torch.arange(6.).reshape(2, 3)
    np.testing.assert_array_equal(parallel.all_gather_host(x), x.numpy())
