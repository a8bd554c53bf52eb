"""odtk_tpu_torch's rotated inference path held against the JAX package
on the CPU: rotated NMS, the 6-channel decode, the heads and the whole
post-processed inference of the rotated model, the rotated loader, the
checkpoint written by the port read by JAX, and the CLI.

Inputs are made by numpy from seeds and handed to both packages; the
model runs in fp32. The Pallas kernels of the JAX side run in interpret
mode. Each test states its tolerance and why; the helpers and the
tolerance rules are those of ``tests/test_torch_rotated.py``.
"""

import functools
import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.data import RotatedDataIterator as JaxRotatedIterator
from odtk_tpu.io import checkpoint as jax_checkpoint
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu.ops.decode import decode_fused as jax_decode_fused
from odtk_tpu.ops.nms import nms_rotated as jax_nms_rotated
from odtk_tpu.ops.pallas.nms_rotated_kernel import nms_rotated_pallas
from odtk_tpu_torch import main as cli
from odtk_tpu_torch.data import RotatedDataIterator
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops import decode_fused, generate_anchors_rotated
from odtk_tpu_torch.ops import iou_rotated
from odtk_tpu_torch.ops.kernels import nms_rotated as knms
from odtk_tpu_torch.utils import rotate_box

from synth import make_dataset
from test_torch_rotated import (ANGLES, CLASSES, RATIOS, SCALES,
                                _assert_far_from, _corners, _sincos_boxes,
                                _t)
from test_torch_rotated_train import _port, rotated_jax_variables
from torch_decode_route import decode_route  # noqa: F401 (a fixture)
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_variables():
    return rotated_jax_variables()


# ------------------------------------------------------------------ NMS
def _nms_case(kind, b=2, n=300, seed=10):
    rng = np.random.RandomState(seed)
    boxes = np.stack([_sincos_boxes(rng, n, 10, 150) for _ in range(b)])
    scores = rng.rand(b, n).astype(np.float32)
    scores[rng.rand(b, n) < 0.3] = 0.0
    classes = rng.randint(0, 3, (b, n)).astype(np.float32)
    if kind == 'ties':
        scores = (np.ceil(scores * 8) / 8).astype(np.float32)
    elif kind == 'empty':
        scores[:] = 0.0
    return scores, boxes, classes


_jax_nms_rotated = jax.jit(functools.partial(
    jax_nms_rotated, nms_thresh=0.5, ndetections=100, use_pallas=False))
_jax_nms_rotated_pallas = jax.jit(functools.partial(
    nms_rotated_pallas, nms_thresh=0.5, ndetections=100, interpret=True))


@pytest.mark.parametrize('kind', ['random', 'empty', 'ties'])
def test_nms_rotated_matches_jax_and_pallas(kind):
    """The plain rotated NMS against JAX's jnp form and the interpret-mode
    Pallas kernel: the same detections (scores, boxes and classes are
    copied from the inputs, so equal). Same-class IoUs keep 1e-4 away
    from the threshold."""
    scores, boxes, classes = _nms_case(kind)
    got = knms.nms_rotated(_t(scores), _t(boxes), _t(classes), 0.5, 100)
    want = _jax_nms_rotated(scores, boxes, classes)
    pallas = _jax_nms_rotated_pallas(scores, boxes, classes)
    for g, w, p in zip(got, want, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    kept = (got[0] > 0).sum(1)
    if kind == 'empty':
        assert (kept == 0).all()
    else:
        assert (kept > 10).all() and (got[0][:, :-1] >= got[0][:, 1:]).all()
    corners = _t(_corners(boxes.reshape(-1, 6)).reshape(2, -1, 8))
    for i in range(2):
        cx, cy = iou_rotated._corner_lists(corners[i], 1)
        iou = iou_rotated.clip_iou(corners[i], cx, cy).numpy()   # [N, N]
        same = classes[i][:, None] == classes[i][None, :]
        _assert_far_from(iou[same], (0.5,))


# --------------------------------------------------------------- decode
def test_decode_fused_rotated_matches_jax():
    """6-channel decode with one global top-k: scores within 1e-6 (the
    sigmoid of the same logits), classes equal, boxes within 1e-3 px
    (exp of the deltas), sin and cos carried through exactly."""
    rng = np.random.RandomState(11)
    a, k = 27, CLASSES
    shapes = [(4, 6), (2, 3)]
    cls_heads = [rng.randn(2, h, w, a * k).astype(np.float32) * 2
                 for h, w in shapes]
    box_heads = [rng.randn(2, h, w, a * 6).astype(np.float32) * 0.3
                 for h, w in shapes]
    strides = [8, 16]
    tables = [generate_anchors_rotated(s, RATIOS, SCALES, ANGLES)[0]
              for s in strides]
    got = decode_fused([_t(c) for c in cls_heads],
                       [_t(b) for b in box_heads], strides, tables,
                       threshold=0.05, top_n=200, total_top_n=300,
                       rotated=True)
    want = jax_decode_fused(
        [jnp.asarray(c) for c in cls_heads],
        [jnp.asarray(b) for b in box_heads], strides, tables,
        threshold=0.05, top_n=200, rotated=True, from_logits=True,
        exact=True, total_top_n=300)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-3)
    assert got[1].shape == (2, 300, 6) and (got[0] > 0).sum() > 100


def test_rotated_heads_match_jax(jax_variables):
    """Per-level heads on 2 x 128x128 images, fp32: atol 1e-4 x max|head|
    (the convolutions sum in another order)."""
    x = np.random.RandomState(14).randn(2, 128, 128, 3).astype(np.float32)
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=True)
    want_cls, want_box = jmodel.module.apply(jax_variables, x)
    got_cls, got_box = _port(jax_variables).forward_heads(_t(x))
    for got, want in zip(got_cls + got_box, want_cls + want_box):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert got_box[0].shape[-1] == 162


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


def test_rotated_inference_fn_matches_jax(jax_variables):
    """The whole rotated inference (normalize, backbone, heads, 6-channel
    decode, rotated NMS) from the same weights, fp32, threshold 0.001:
    detections matched by (class, score), scores within 1e-5, boxes
    within 1e-2 px, sin and cos within 1e-4."""
    config = {'threshold': 0.001}
    rng = np.random.RandomState(15)
    u8 = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    sizes = np.asarray([[128, 128], [100, 120]], np.float32)
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES, rotated_bbox=True,
                      config=config)
    want = jax.jit(jmodel.inference_fn_u8)(jax_variables, u8, sizes)
    got = _port(jax_variables, config).inference_fn_u8(_t(u8), _t(sizes))
    for i in range(2):
        g = _by_class_score(*(t[i].numpy() for t in got))
        w = _by_class_score(*(np.asarray(t[i]) for t in want))
        assert len(g[0]) == len(w[0]) > 10
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g[1][:, :4], w[1][:, :4], rtol=0,
                                   atol=1e-2)
        np.testing.assert_allclose(g[1][:, 4:], w[1][:, 4:], rtol=0,
                                   atol=1e-4)


# ---------------------------------------------------------- checkpoints
def test_rotated_checkpoint_from_port_loads_in_jax(tmp_path):
    path = str(tmp_path / 'port.pth')
    port = Model('ResNet18FPN', classes=CLASSES, rotated_bbox=True,
                 angles=[-0.5, 0.5]).initialize(5)
    port.save({'path': path, 'iteration': 2})
    restored, state = jax_checkpoint.load(path)
    assert restored.rotated_bbox and restored.num_anchors == 18
    np.testing.assert_allclose(restored.angles, [-0.5, 0.5])
    sd = variables_to_state_dict(restored.variables)
    for k, v in port.module.state_dict().items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy(),
                                      err_msg=k)


# ----------------------------------------------------------------- data
@pytest.fixture(scope='module')
def rotated_data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_rotated')
    return make_dataset(str(root), n_images=4, size=(100, 120), max_boxes=5,
                        seed=16, rotated=True, fmt='jpg')


def _epoch(cls, img_dir, random_seed, **kw):
    """One whole epoch: the augmentations draw from the global ``random``
    in the loader's worker thread, so an iterator left with work queued
    would go on drawing while the next one runs."""
    it = cls(img_dir, num_threads=1, **kw)
    random.seed(random_seed)
    return list(it)


@pytest.mark.parametrize('augment', ['flip', 'rotate', 'absolute_angle'])
def test_rotated_loader_matches_jax(rotated_data, augment, decode_route):
    """RotatedDataIterator: images, (x, y, w, h, theta, class) targets,
    colour affines and sizes equal to the JAX loader's for the same
    seeds, with flips, 90-degree rotations and the absolute-angle
    fold, both loaders on one decode route."""
    img_dir, ann = rotated_data
    kw = dict(resize=[80, 112], max_size=128, batch_size=2, stride=32,
              world=1, annotations=ann, training=True, max_det=6, seed=7,
              augment_brightness=0.1, augment_contrast=0.1, emit='u8',
              rotate_augment=augment != 'flip',
              absolute_angle=augment == 'absolute_angle')
    got = _epoch(RotatedDataIterator, img_dir, 3, **kw)
    want = _epoch(JaxRotatedIterator, img_dir, 3, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    targets = np.concatenate([g[1] for g in got])
    assert targets.shape[-1] == 6 and (targets[..., 4] != 0).any()


def test_rotate_box_matches_jax():
    from odtk_tpu.utils import rotate_box as jax_rotate_box
    for box in ([10.0, 20.0, 30.0, 12.0, 0.3], [0.0, 0.0, 5.0, 9.0, -1.2]):
        assert rotate_box(box) == jax_rotate_box(box)


# ------------------------------------------------------------------ CLI
_CLI_RUN = r'''
import json, random, sys
sys.path.insert(0, {tests!r})
from synth import make_dataset
before = set(sys.modules)
from odtk_tpu_torch import main as cli
img, ann = make_dataset({root!r}, n_images=4, size=(96, 128), max_boxes=4,
                        rotated=True, fmt='jpg')
random.seed(0)
common = ['--images', img, '--annotations', ann, '--batch', '2',
          '--resize', '96', '--max-size', '128', '--device', 'cpu',
          '--full-precision']
train = cli.main(['train', {ckpt!r}, '--backbone', 'ResNet18FPN',
                  '--classes', '3', '--jitter', '96', '112', '--iters', '2',
                  '--warmup', '1', '--milestones', '1', '--rotated-bbox']
                 + common)
result = cli.main(['infer', {ckpt!r}, '--output', {det!r},
                   '--threshold', '0.001', '--rotated-bbox'] + common)
mods = {{m.split('.')[0] for m in set(sys.modules) - before}}
print(json.dumps({{'losses': train['losses'],
                  'stats': None if result['stats'] is None
                  else [float(s) for s in result['stats']],
                  'leaked': sorted(mods & {{'odtk_tpu', 'jax', 'jaxlib',
                                            'flax', 'optax'}})}}))
'''


def test_cli_rotated_train_then_infer(tmp_path):
    """``train --rotated-bbox`` for 2 iterations on the CPU writes a .pth
    with ``angles``; ``infer --rotated-bbox`` on it writes [x, y, w, h,
    theta] boxes with a ``segmentation`` polygon and evaluates 'segm';
    nothing of JAX is imported."""
    ckpt = str(tmp_path / 'rot.pth')
    det = str(tmp_path / 'det.json')
    code = _CLI_RUN.format(tests=os.path.join(REPO, 'tests'),
                           root=str(tmp_path), ckpt=ckpt, det=det)
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'BBOX type: rotated' in out.stdout
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report['leaked'] == []
    assert [it for it, _, _ in report['losses']] == [0, 1]
    assert np.isfinite(np.asarray(report['losses'])).all()
    assert report['stats'] is not None and len(report['stats']) == 12
    checkpoint = torch.load(ckpt, weights_only=True)
    np.testing.assert_allclose(checkpoint['angles'], ANGLES)
    with open(det) as f:
        dets = json.load(f)['annotations']
    assert dets
    for d in dets:
        assert len(d['bbox']) == 5 and len(d['segmentation'][0]) == 8
        assert np.isfinite(d['bbox'] + d['segmentation'][0]).all()
        assert d['segmentation'][0] == rotate_box(d['bbox'])


def test_unported_flag_names_its_roadmap_item():
    """--num-hosts > 1, once unported, now passes the parse and the
    startup checks (data parallel, ROADMAP Queue 1 item 7, done); the
    train flags of the JAX CLI, the rotated ones among them, parse and
    do not raise either."""
    args = cli.parse(['--num-hosts', '2', 'train', 'm.pth',
                      '--annotations', 'a.json'])
    cli._refuse_unported(args)
    assert args.num_hosts == 2 and cli.local_processes(args) >= 1
    args = cli.parse(['train', 'm.ckpt', '--annotations', 'a.json',
                      '--rotated-bbox', '--absolute-angle',
                      '--anchor-angles', '-0.5', '0', '0.5',
                      '--logdir', 'logs', '--profile-dir', 'trace',
                      '--post-metrics', 'http://127.0.0.1:1/',
                      '--backbone-weights', 'w.pth'])
    cli._refuse_unported(args)
    assert args.rotated_bbox and args.anchor_angles == [-0.5, 0.0, 0.5]
    assert (args.logdir, args.profile_dir, args.backbone_weights) == (
        'logs', 'trace', ['w.pth'])
