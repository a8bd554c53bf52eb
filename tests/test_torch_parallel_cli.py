"""The port's CLI at world 2 on the CPU: ``--num-hosts 2 --host-id {0,1}
--master`` (one gloo process a host) for ``train`` with validation and
for ``infer``, one host spawning a process a card, and the startup
guards of a batch that does not divide.
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_file_loader import \
    EventFileLoader

from odtk_tpu_torch import main as cli
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch.model import Model

from synth import make_dataset
from torch_ranks import free_port
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ['--resize', '96', '--max-size', '128', '--device', 'cpu',
         '--full-precision']
WAIT_S = 240


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Five 96 x 128 JPEGs (one canvas, so every batch has the same
    shape; five, so the second rank's shard wraps round to image 0) and
    a ResNet18FPN checkpoint whose class bias is 0: its random weights
    score ~0.5, over the 0.05 threshold, so validation has detections."""
    root = tmp_path_factory.mktemp('parallel_cli')
    img, ann = make_dataset(str(root), n_images=5, size=(96, 128),
                            fmt='jpg')
    model = Model('ResNet18FPN', classes=3).initialize(0)
    torch.nn.init.zeros_(model.module.cls_head[8].bias)
    ckpt = str(root / 'init.pth')
    model.save({'path': ckpt})
    return img, ann, ckpt


def _hosts(argv_of, cwd):
    """``odtk_tpu_torch.main`` as hosts 0 and 1 of a world-2 group, each
    with its own arguments; returns their (returncode, stdout, stderr)."""
    master = f'127.0.0.1:{free_port()}'
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'odtk_tpu_torch.main', '--num-hosts', '2',
         '--host-id', str(i), '--master', master] + argv_of(i), cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, *out) for p, out in zip(procs, outs)]


def _scalars(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, 'events.out.tfevents.*'))
    return {value.tag: value.tensor.float_val[0]
            for event in EventFileLoader(path).Load()
            for value in event.summary.value}


def _world1_infer(ckpt, img, ann, out, *flags):
    return cli.main(['infer', ckpt, '--images', img, '--annotations', ann,
                     '--batch', '1', '--output', out, *flags] + SIZES)


def test_train_at_world_2_validates_on_gathered_results(tmp_path, data):
    """Two hosts train 2 steps of a global batch of 2 and validate at the
    end: both exit 0; rank 0 alone writes its checkpoint (host 1's file
    keeps its first bytes) and its event file; the logged losses are finite;
    the validation scalars equal the COCO stats of a world-1 ``infer`` of
    the checkpoint on all five images (batch 1, each rank's batch), so
    the ranks' results were gathered before rank 0 scored them."""
    img, ann, init = data
    for i in range(2):
        with open(init, 'rb') as src, \
                open(tmp_path / f'model{i}.pth', 'wb') as dst:
            dst.write(src.read())
    runs = _hosts(lambda i: [
        'train', f'model{i}.pth', '--images', img, '--annotations', ann,
        '--val-annotations', ann, '--val-iters', '2', '--backbone',
        'ResNet18FPN', '--classes', '3', '--iters', '2', '--warmup', '1',
        '--milestones', '1', '--batch', '2', '--jitter', '96', '112',
        '--lr', '0.001', '--logdir', f'logs{i}'] + SIZES, str(tmp_path))
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
    assert Model.load(str(tmp_path / 'model0.pth'))[1]['iteration'] == 2
    with open(init, 'rb') as a, open(tmp_path / 'model1.pth', 'rb') as b:
        assert a.read() == b.read()
    assert not os.path.exists(tmp_path / 'logs1')
    (line,) = [ln for ln in runs[0][1].splitlines() if ln.startswith('[2/2]')]
    losses = re.findall(r'(focal|box) loss: (\S+),', line)
    assert len(losses) == 2 and all(np.isfinite(float(v)) for _, v in losses)
    assert '[2/2]' not in runs[1][1]

    scalars = _scalars(str(tmp_path / 'logs0'))
    got = [scalars[re.sub(r'[^-/\w.]', '_', tag)]
           for tag in port_train.VALIDATION_TAGS]
    stats = _world1_infer(str(tmp_path / 'model0.pth'), img, ann,
                          str(tmp_path / 'det.json'))['stats']
    assert max(stats) > 0
    np.testing.assert_allclose(got, stats, rtol=1e-6)


def test_divergence_stops_every_rank(tmp_path, data):
    """A learning rate that blows the weights up: the losses go
    non-finite, and both hosts raise "Loss is diverging!" at the same
    sync, the last step's, instead of one waiting in a collective for
    the other."""
    img, ann, init = data
    runs = _hosts(lambda i: [
        'train', f'model{i}.pth', '--images', img, '--annotations', ann,
        '--backbone', 'ResNet18FPN', '--classes', '3', '--iters', '3',
        '--warmup', '0', '--milestones', '3', '--batch', '2', '--jitter',
        '96', '96', '--lr', '1e12', '--no-pretrained'] + SIZES,
        str(tmp_path))
    for rc, _, err in runs:
        assert rc != 0
        assert re.search(r'Loss is diverging! \(iteration \d', err), \
            err[-3000:]
    assert not os.path.exists(tmp_path / 'model0.pth')


def _annotations(path):
    with open(path) as f:
        return json.load(f)['annotations']


def test_infer_at_world_2_equals_world_1(tmp_path, data):
    """Two hosts infer with a global batch of 2: rank 0 alone writes the
    JSON; it holds each of the five images once (image 0 was on both
    ranks) and equals the world-1 run's detections (batch 1)."""
    img, ann, ckpt = data
    runs = _hosts(lambda i: [
        'infer', ckpt, '--images', img, '--annotations', ann, '--batch', '2',
        '--threshold', '0.001', '--output', f'det{i}.json'] + SIZES,
        str(tmp_path))
    for rc, _, err in runs:
        assert rc == 0, err[-3000:]
    assert not os.path.exists(tmp_path / 'det1.json')
    _world1_infer(ckpt, img, ann, str(tmp_path / 'one.json'), '--threshold',
                  '0.001')
    got, want = (_annotations(tmp_path / f) for f in ('det0.json',
                                                      'one.json'))
    assert got == want
    with open(ann) as f:
        ids = sorted(im['id'] for im in json.load(f)['images'])
    assert sorted({d['image_id'] for d in got}) == ids and len(ids) == 5


def test_one_host_spawns_a_process_a_card(tmp_path, data):
    """One host with two cards (``local_devices`` says 2; on the CPU the
    spawned ranks run gloo) spawns two ranks: the JSON equals the
    world-1 run's."""
    img, ann, ckpt = data
    args = ['--master', f'127.0.0.1:{free_port()}', 'infer', ckpt,
            '--images', img, '--annotations', ann, '--batch', '2',
            '--threshold', '0.001', '--output', 'det.json'] + SIZES
    code = ('from odtk_tpu_torch import main as cli\n'
            'cli.local_devices = lambda device: 2\n'
            f'cli.main({args!r})\n')
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=WAIT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count('Preparing dataset...') == 2
    _world1_infer(ckpt, img, ann, str(tmp_path / 'one.json'), '--threshold',
                  '0.001')
    assert _annotations(tmp_path / 'det.json') == \
        _annotations(tmp_path / 'one.json')


def test_batch_not_dividing_over_hosts_exits_at_startup(tmp_path, data):
    """A global batch of 3 over 2 hosts: the process exits non-zero with
    the JAX package's message before it loads anything."""
    img, ann, ckpt = data
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    out = subprocess.run(
        [sys.executable, '-m', 'odtk_tpu_torch.main', '--num-hosts', '2',
         '--master', f'127.0.0.1:{free_port()}', 'infer', ckpt, '--images',
         img, '--batch', '3', '--output', 'det.json'] + SIZES,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=WAIT_S)
    assert out.returncode != 0
    assert 'RuntimeError: Batch size should be a multiple of the number of ' \
           'hosts' in out.stderr
    assert 'Loading model' not in out.stdout


def test_batch_not_dividing_over_cards_raises_at_startup(monkeypatch, data):
    """Two hosts of 8 cards and a global batch of 4: the per-host batch of
    2 does not divide over the cards."""
    img, _, ckpt = data
    monkeypatch.setattr(cli, 'local_devices', lambda device: 8)
    with pytest.raises(RuntimeError, match='Per-host batch size should be a '
                                           'multiple of the local device '
                                           'count'):
        cli.main(['--num-hosts', '2', 'infer', ckpt, '--images', img,
                  '--batch', '4'])
