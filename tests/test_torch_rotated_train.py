"""odtk_tpu_torch's rotated-box model held against the JAX package on
the CPU: heads, post-processed inference, ``loss_fn``, one SGD step, and
a JAX-written checkpoint.

One set of JAX variables is drawn per module (the port's seeded init
read through the JAX package's importer, then the frozen batch-norm
statistics and the final head kernels redrawn by numpy) and carried to
the port by its weight bridge; both packages run the same numpy inputs
in fp32. Each test states its tolerance and why.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from odtk_tpu.io.torch_import import (state_dict_to_variables,
                                      variables_to_state_dict)
from odtk_tpu.model import Model as JaxModel
from odtk_tpu.ops.color import apply_color_affine as jax_color_affine
from odtk_tpu.parallel import make_mesh, shard_batch
from odtk_tpu import train as jax_train
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch.data import RotatedDataIterator
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops import iou_rotated, rotate_boxes
from odtk_tpu_torch.ops.assign import level_anchors

from synth import make_dataset
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
ANGLES = [-np.pi / 6, 0, np.pi / 6]


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_far_from(values, cuts, margin=1e-4):
    values = np.asarray(values)
    for cut in cuts:
        assert np.abs(values - cut).min() > margin, \
            f'test data has a value within {margin} of {cut}'


def rotated_jax_variables():
    """ResNet18FPN rotated (3 classes, 27 anchors) JAX variables. The
    template comes from ``eval_shape`` (no init compile); the weights
    from the port's seeded init through the JAX importer; the frozen
    statistics (so the stem's scale is not 1) and the final head kernels
    (at a std that spreads the logits: at the 0.01 init every score sits
    near the prior and conv-order noise would reorder near-ties) are
    redrawn by numpy."""
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=True)
    shapes = jax.eval_shape(jmodel.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3), jnp.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            unfreeze(shapes))
    port = Model('ResNet18FPN', classes=CLASSES,
                 rotated_bbox=True).initialize(0)
    v, report = state_dict_to_variables(
        {k: t.numpy() for k, t in port.module.state_dict().items()},
        template)
    assert not report['missing']
    rng = np.random.RandomState(13)

    def draw(path, leaf):
        if path[-1].key in ('var', 'scale'):
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    v['frozen'] = jax.tree_util.tree_map_with_path(draw, v['frozen'])
    for name, std in (('cls_head_8', 1.0), ('box_head_8', 0.1)):
        kernel = v['params'][name]['kernel']
        v['params'][name]['kernel'] = (
            rng.randn(*kernel.shape) * std).astype(np.float32)
    return v


@pytest.fixture(scope='module')
def jax_variables():
    return rotated_jax_variables()


def _port(variables, config=None):
    model = Model('ResNet18FPN', classes=CLASSES, rotated_bbox=True,
                  config=config)
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def test_rotated_model_layout_and_init():
    """27 anchors, a box head of 6 x 27 channels with the pi = 0.01 prior
    on its final bias, angles [-pi/6, 0, pi/6]; fine-tune surgery skips
    both final convs."""
    m = Model('ResNet18FPN', classes=CLASSES, rotated_bbox=True).initialize(0)
    assert m.num_anchors == 27 and m.box_size == 6
    np.testing.assert_allclose(m.angles, ANGLES)
    sd = m.module.state_dict()
    assert sd['box_head.8.weight'].shape == (162, 256, 3, 3)
    np.testing.assert_allclose(sd['box_head.8.bias'].numpy(), -np.log(99.0),
                               rtol=1e-6)


@pytest.fixture(scope='module')
def rotated_data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_rotated')
    return make_dataset(str(root), n_images=4, size=(100, 120), max_boxes=2,
                        seed=44, rotated=True, fmt='jpg')


@pytest.fixture(scope='module')
def batch(rotated_data):
    """One u8 rotated training batch of the port's loader (held equal to
    the JAX package's by the data test below)."""
    img_dir, ann = rotated_data
    it = RotatedDataIterator(img_dir, 96, 128, 2, 128, 1, ann, training=True,
                             max_det=8, seed=1, num_threads=1, emit='u8',
                             augment_brightness=0.05,
                             augment_contrast=0.05)
    random.seed(2)
    out = list(it)
    return out[0]


LR, WARMUP, MILESTONES, GAMMA, WD = 0.01, 10, [100, 200], 0.1, 1e-4


def _by_name(tree, variables):
    return state_dict_from_jax({'params': tree,
                                'frozen': variables['frozen']})


def _assert_tensors_close(got, want, rel, floor=None):
    for name, w in want.items():
        w = np.asarray(w)
        atol = rel * max(np.abs(w).max(), 1e-12)
        if floor is not None:
            atol = max(atol, floor[name])
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope='module')
def jax_step(jax_variables, batch):
    """One rotated u8 SGD step of the JAX package from the bridged
    weights; host copies of its parameters, momentum and losses."""
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=True)
    tx = jax_train.make_optimizer(LR, WARMUP, MILESTONES, GAMMA, WD)
    mesh = make_mesh(jax.devices()[:1])
    step = jax_train.make_train_step(jmodel, tx, mesh, feed='u8')
    params = jax_variables['params']
    u8, targets, colors, sizes = batch
    args = shard_batch(mesh, u8, colors, sizes, targets)
    p1, o1, cl, bl = step(params, tx.init(params), jax_variables['frozen'],
                          *args)
    return dict(p1=jax.device_get(p1), o1=jax.device_get(o1),
                loss=(float(cl), float(bl)))


def test_rotated_loss_fn_matches_jax(jax_variables, batch, jax_step):
    """Model.loss_fn on the rotated batch (the colour affine applied as
    the JAX step applies it) against the JAX step's losses: rtol 1e-4
    (convolutions and the loss sums in other orders); the assignment's
    best IoUs keep 1e-4 away from lo and hi."""
    u8, targets, colors, sizes = batch
    images = np.asarray(jax_color_affine(u8, colors, sizes))
    model = _port(jax_variables)
    with torch.no_grad():
        cl, bl = model.loss_fn(_t(images), _t(targets))
    np.testing.assert_allclose([cl.item(), bl.item()], jax_step['loss'],
                               rtol=1e-4)
    assert bl.item() > 0
    _, quads = rotate_boxes(_t(np.concatenate(
        [targets[..., :2], np.maximum(targets[..., 2:4], 1e-4),
         targets[..., 4:5]], -1)))
    h, w = images.shape[1:3]
    for stride in (8, 16, 32, 64, 128):
        anchors = level_anchors(w // stride, h // stride, stride,
                                model.anchors(stride)[1], 'cpu')
        best, _ = iou_rotated.rotated_best_match_batched(
            anchors, quads, _t(targets[..., 5] > -1), skip_ratio=0.4)
        _assert_far_from(best.numpy(), (0.4, 0.5))


def test_rotated_train_step_matches_jax(jax_variables, batch, jax_step):
    """One fp32 rotated u8 SGD step (momentum 0.9, weight decay 1e-4,
    warmup lr) from the same weights and batch: the losses at rtol 1e-4;
    the parameter change and the momentum buffers within 1e-3 of each
    tensor's largest entry, the change also within two fp32 ulps of the
    tensor's largest parameter (the rounding of p - lr * mu)."""
    model = _port(jax_variables)
    opt = port_train.make_optimizer(model.module.parameters(), LR, WD)
    step = port_train.make_train_step(model, opt, feed='u8')
    schedule = port_train.lr_schedule(LR, WARMUP, MILESTONES, GAMMA)
    params = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    cl, bl = step(schedule(0), *(_t(a) for a in batch))
    np.testing.assert_allclose([cl.item(), bl.item()], jax_step['loss'],
                               rtol=1e-4)
    want_p = _by_name(jax_step['p1'], jax_variables)
    want_mu = _by_name(jax_step['o1'][1].trace, jax_variables)
    got_delta = {k: p.detach() - before[k] for k, p in params.items()}
    want_delta = {k: (want_p[k] - before[k]).numpy() for k in params}
    ulps = {k: 2 * float(np.spacing(np.abs(p.numpy()).max()))
            for k, p in before.items()}
    _assert_tensors_close(got_delta, want_delta, 1e-3, ulps)
    got_mu = {k: opt.state[p]['momentum_buffer'] for k, p in params.items()}
    _assert_tensors_close(got_mu, {k: want_mu[k] for k in params}, 1e-3)
    assert float(np.abs(want_delta['box_head.8.weight']).max()) > 0


def test_rotated_checkpoint_from_jax_loads_in_port(jax_variables, tmp_path):
    """A rotated .pth written by the JAX package loads in the port as a
    rotated model with its angles and the same tensors."""
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=True)
    jmodel.variables = jax_variables
    path = str(tmp_path / 'jax.pth')
    jmodel.save({'path': path, 'iteration': 3})
    port, state = Model.load(path)
    assert port.rotated_bbox and state['iteration'] == 3
    np.testing.assert_allclose(port.angles, ANGLES)
    sd = variables_to_state_dict(jax_variables)
    for k, v in port.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]),
                                      err_msg=k)


def test_rotated_fine_tune_copies_all_but_both_final_convs(tmp_path):
    """Fine-tune surgery of a rotated model: every module of the donor
    is grafted but ``cls_head.8`` and ``box_head.8``, which keep their
    fresh init (``odtk_tpu/model.py:266-268``)."""
    donor = Model('ResNet18FPN', classes=CLASSES,
                  rotated_bbox=True).initialize(1)
    path = str(tmp_path / 'donor.pth')
    donor.save({'path': path})
    fresh = Model('ResNet18FPN', classes=CLASSES,
                  rotated_bbox=True).initialize(2)
    tuned = Model('ResNet18FPN', classes=CLASSES,
                  rotated_bbox=True).initialize(2, fine_tune=path)
    d, f, t = (m.module.state_dict() for m in (donor, fresh, tuned))
    for k in t:
        final = k.startswith(('cls_head.8.', 'box_head.8.'))
        assert torch.equal(t[k], f[k] if final else d[k]), k
    assert not torch.equal(d['box_head.8.weight'], f['box_head.8.weight'])
