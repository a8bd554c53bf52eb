"""The yuv420 feed of odtk_tpu_torch held against the JAX package's.

The loader's RGB -> YCbCr 4:2:0 planes, the colour affines that fold the
conversion, the on-device assembly, the loader's batches, one SGD step
and ``infer`` on the feed, each on the same seeded numpy inputs in both
packages on the CPU, fp32. Each test states its tolerance.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from odtk_tpu import infer as jax_infer
from odtk_tpu import train as jax_train
from odtk_tpu.data import DataIterator as JaxIterator
from odtk_tpu.data import loader as jax_loader
from odtk_tpu.io import checkpoint as jax_checkpoint
from odtk_tpu.model import Model as JaxModel
from odtk_tpu.ops import color as jax_color
from odtk_tpu.parallel import make_mesh, shard_batch
from odtk_tpu_torch import infer as port_infer
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch.data import DataIterator, loader, native
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops import (apply_color_affine_yuv, eval_normalize_u8,
                                eval_normalize_yuv)

from synth import make_dataset
from torch_decode_route import decode_route  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 4
LR, WARMUP, MILESTONES, GAMMA, WD = 0.01, 10, [100, 200], 0.1, 1e-4
SIZES = [(16, 24), (15, 23), (1, 1), (7, 2), (2, 9), (33, 48)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_yuv420')
    return make_dataset(str(root), n_images=5, size=(100, 130), max_boxes=3,
                        seed=4, fmt='jpg')


# ------------------------------------------------------------ conversion
@pytest.mark.parametrize('hw', SIZES)
def test_numpy_twin_bit_equal(hw):
    rgb = (np.random.RandomState(sum(hw)).rand(*hw, 3) * 255).astype(
        np.uint8)
    for got, want in zip(loader._rgb_to_yuv420_numpy(rgb),
                         jax_loader._rgb_to_yuv420_numpy(rgb)):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert got.shape == ((hw[0] + 1) // 2, (hw[1] + 1) // 2, 2)


def test_native_converter_within_one_lsb_of_numpy():
    """``native/host_decode.cpp``'s converter through the port's bridge
    within 1 LSB of the numpy twin, odd edge blocks included, and equal
    to the JAX bridge's where that one loads."""
    assert native.rgb_to_yuv420(np.zeros((2, 2, 3), np.uint8)) is not None
    rng = np.random.RandomState(9)
    for h, w in SIZES:
        rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        got = native.rgb_to_yuv420(rgb)
        twin = loader._rgb_to_yuv420_numpy(rgb)
        for g, t in zip(got, twin):
            assert g.shape == t.shape
            assert np.abs(g.astype(int) - t.astype(int)).max() <= 1, (h, w)
        for g, want in zip(got, loader.rgb_to_yuv420(rgb)):
            np.testing.assert_array_equal(g, want)


def test_fold_yuv_affine_equal():
    rng = np.random.RandomState(3)
    colors = rng.randn(3, 3, 4).astype(np.float32)
    got = loader.fold_yuv_affine(colors)
    np.testing.assert_array_equal(got, jax_loader.fold_yuv_affine(colors))
    np.testing.assert_array_equal(loader._YUV_A, jax_loader._YUV_A)
    np.testing.assert_array_equal(loader._YUV_B, jax_loader._YUV_B)


# ----------------------------------------------------------------- colour
def _planes(rng, b, h, w):
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    c = rng.randint(0, 256, (b, h // 2, w // 2, 2)).astype(np.uint8)
    return y, c


def test_apply_color_affine_yuv_matches_jax():
    """The per-image affine on assembled planes, clip and pad mask:
    atol 1e-6 (fp32 multiply-adds in the JAX order)."""
    rng = np.random.RandomState(7)
    y, c = _planes(rng, 2, 16, 24)
    colors = loader.fold_yuv_affine(np.concatenate(
        [(rng.randn(2, 3, 3) * 0.01).astype(np.float32),
         rng.randn(2, 3, 1).astype(np.float32)], axis=2))
    sizes = np.asarray([[16, 24], [9, 13]], np.float32)
    got = apply_color_affine_yuv(_t(y), _t(c), _t(colors), _t(sizes)).numpy()
    want = np.asarray(jax_color.apply_color_affine_yuv(y, c, colors, sizes))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.dtype == np.float32 and got.shape == (2, 16, 24, 3)
    assert (got[1, 9:] == 0).all() and (got[1, :, 13:] == 0).all()


def test_eval_normalize_yuv_matches_jax():
    rng = np.random.RandomState(8)
    y, c = _planes(rng, 2, 12, 16)
    sizes = np.asarray([[12, 16], [9, 13]], np.float32)
    got = eval_normalize_yuv(_t(y), _t(c), _t(sizes)).numpy()
    want = np.asarray(jax_color.eval_normalize_yuv(y, c, sizes))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_eval_normalize_yuv_exact_on_gray():
    """On grey content the yuv420 eval feed is the u8 feed up to the
    planes' u8 rounding (atol 0.03, as the JAX package's test), and
    equal to JAX's within 1e-6."""
    g = np.repeat(np.arange(0, 240, 10, dtype=np.uint8)
                  .reshape(4, 6)[..., None], 3, axis=-1)
    y, c = loader.rgb_to_yuv420(g)
    sizes = np.asarray([[4, 6]], np.float32)
    want = eval_normalize_u8(_t(g[None]), _t(sizes)).numpy()
    got = eval_normalize_yuv(_t(y[None]), _t(c[None]), _t(sizes)).numpy()
    np.testing.assert_allclose(got, want, atol=0.03)
    np.testing.assert_allclose(
        got, np.asarray(jax_color.eval_normalize_yuv(y[None], c[None],
                                                     sizes)),
        rtol=0, atol=1e-6)


# ----------------------------------------------------------------- loader
def _epoch(cls, img_dir, random_seed, n, **kw):
    """One whole epoch: the augmentations draw from the global
    ``random`` in the worker thread, so no work is left queued behind
    the next iterator."""
    it = cls(img_dir, num_threads=1, **kw)
    random.seed(random_seed)
    out = list(it)
    assert len(out) == n
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def test_train_batches_equal(dataset, decode_route):
    """(y, cbcr, targets, colors, sizes) with resize jitter, flips and
    colour jitter, for the same seeds: equal."""
    img_dir, ann = dataset
    kw = dict(resize=[80, 112], max_size=128, batch_size=2, stride=32,
              world=1, annotations=ann, training=True, max_det=4, seed=7,
              augment_brightness=0.1, augment_contrast=0.1,
              augment_hue=0.05, augment_saturation=0.1, emit='yuv420')
    got = _epoch(DataIterator, img_dir, 3, 3, **kw)
    _assert_same(got, _epoch(JaxIterator, img_dir, 3, 3, **kw))
    y, cbcr, targets, colors, sizes = got[0]
    assert y.dtype == cbcr.dtype == np.uint8
    assert cbcr.shape == (2, y.shape[1] // 2, y.shape[2] // 2, 2)
    assert colors.shape == (2, 3, 4) and sizes.shape == (2, 2)


def test_eval_batches_equal(dataset, decode_route):
    """(y, cbcr, ids, ratios, sizes), the whole canvas converted."""
    img_dir, ann = dataset
    kw = dict(resize=96, max_size=128, batch_size=2, stride=32, world=1,
              annotations=ann, training=False, emit='yuv420')
    got = _epoch(DataIterator, img_dir, 0, 3, **kw)
    _assert_same(got, _epoch(JaxIterator, img_dir, 0, 3, **kw))
    assert len(got[0]) == 5 and got[0][2].dtype == np.int64


def test_odd_canvas_refused(dataset):
    """A fixed odd canvas cannot hold 2x2 chroma blocks: the train batch
    raises the JAX package's ValueError."""
    img_dir, ann = dataset
    kw = dict(resize=64, max_size=96, batch_size=2, stride=32, world=1,
              annotations=ann, training=True, fixed_size=(97, 96),
              emit='yuv420')
    errors = []
    for cls in (DataIterator, JaxIterator):
        with pytest.raises(ValueError, match='yuv420 feed needs an even '
                                             'canvas') as e:
            _epoch(cls, img_dir, 0, 3, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------- train step
@pytest.fixture(scope='module')
def variables():
    """ResNet18FPN (4 classes) JAX variables with the frozen batch-norm
    statistics drawn by numpy, so the stem's scale is not 1."""
    model = JaxModel('ResNet18FPN', classes=CLASSES)
    v = jax.tree.map(np.asarray, model.initialize(rng=0,
                                                  image_size=(128, 128)))
    rng = np.random.RandomState(8)

    def draw(path, leaf):
        if path[-1].key in ('var', 'scale'):
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    v['frozen'] = jax.tree_util.tree_map_with_path(draw, v['frozen'])
    return v


def _port(variables, config=None):
    model = Model('ResNet18FPN', classes=CLASSES, config=config)
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _by_name(tree, variables):
    return state_dict_from_jax({'params': tree,
                                'frozen': variables['frozen']})


def _assert_tensors_close(got, want, rel, floor=None):
    """Each tensor within ``rel`` of its own largest entry, or within
    ``floor[name]`` where that is larger."""
    for name, w in want.items():
        w = np.asarray(w)
        atol = rel * max(np.abs(w).max(), 1e-12)
        if floor is not None:
            atol = max(atol, floor[name])
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=atol, err_msg=name)


def test_yuv420_train_step_matches_jax(variables, tmp_path):
    """One yuv420 SGD step (momentum 0.9, weight decay 1e-4, warmup lr)
    from the same weights and a batch of the port's loader: the losses
    at rtol 1e-4; the parameter change and the momentum buffers within
    1e-3 of each tensor's largest entry, the change also within two fp32
    ulps of the tensor's largest parameter (``test_u8_train_step_
    matches_jax``'s tolerances)."""
    img_dir, ann = make_dataset(str(tmp_path), n_images=2, size=(100, 120),
                                seed=9, fmt='jpg')
    batch = _epoch(DataIterator, img_dir, 2, 1, resize=96, max_size=128,
                   batch_size=2, stride=128, world=1, annotations=ann,
                   training=True, max_det=8, seed=1, emit='yuv420',
                   augment_brightness=0.05, augment_contrast=0.05)[0]
    y, cbcr, targets, colors, sizes = batch

    jmodel = JaxModel('ResNet18FPN', classes=CLASSES)
    tx = jax_train.make_optimizer(LR, WARMUP, MILESTONES, GAMMA, WD)
    mesh = make_mesh(jax.devices()[:1])
    step = jax_train.make_train_step(jmodel, tx, mesh, feed='yuv420')
    params = variables['params']
    p1, o1, cl, bl = step(params, tx.init(params), variables['frozen'],
                          *shard_batch(mesh, y, cbcr, colors, sizes,
                                       targets))
    p1, o1 = jax.device_get(p1), jax.device_get(o1)

    model = _port(variables)
    opt = port_train.make_optimizer(model.module.parameters(), LR, WD)
    port_step = port_train.make_train_step(model, opt, feed='yuv420')
    schedule = port_train.lr_schedule(LR, WARMUP, MILESTONES, GAMMA)
    named = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    got_cl, got_bl = port_step(schedule(0), *(_t(a) for a in batch))
    np.testing.assert_allclose([got_cl.item(), got_bl.item()],
                               [float(cl), float(bl)], rtol=1e-4)
    want_p = _by_name(p1, variables)
    want_mu = _by_name(o1[1].trace, variables)
    got_delta = {k: p.detach() - before[k] for k, p in named.items()}
    want_delta = {k: (want_p[k] - before[k]).numpy() for k in named}
    ulps = {k: 2 * float(np.spacing(np.abs(p.numpy()).max()))
            for k, p in before.items()}
    _assert_tensors_close(got_delta, want_delta, 1e-3, ulps)
    got_mu = {k: opt.state[p]['momentum_buffer'] for k, p in named.items()}
    _assert_tensors_close(got_mu, {k: want_mu[k] for k in named}, 1e-3)
    assert float(np.abs(want_delta[
        'backbones.ResNet18FPN.features.conv1.weight']).max()) > 0


@pytest.mark.parametrize('env,feed', [(None, 'u8'), ('yuv420', 'yuv420'),
                                      ('f32', 'f32')])
def test_feed_fallback(tmp_path, monkeypatch, capsys, env, feed):
    """``train(feed=None)`` takes ``ODTK_FEED``, then u8 (the JAX trainer
    falls back to yuv420); an explicit feed wins over the variable; an
    unknown one raises."""
    img, ann = make_dataset(str(tmp_path), n_images=2, size=(64, 96),
                            fmt='jpg')
    if env is None:
        monkeypatch.delenv('ODTK_FEED', raising=False)
    else:
        monkeypatch.setenv('ODTK_FEED', env)

    def run(**kw):
        model = Model('ResNet18FPN', classes=3).initialize(0)
        return port_train.train(
            model, {'path': str(tmp_path / 'm.pth')}, img, ann, img, None,
            64, 96, [64, 64], 2, 1, 0, 0.01, 0, [], 0.1,
            mixed_precision=False, verbose=True, device='cpu', **kw)

    out = run()
    assert len(out['losses']) == 1 and np.isfinite(out['losses']).all()
    assert f'feed: {feed}' in capsys.readouterr().out
    run(feed='u8')
    assert 'feed: u8' in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown feed mode 'yuv444'"):
        run(feed='yuv444')


# ------------------------------------------------------------- inference
def _spread_heads(variables, seed=0):
    """The final cls/box conv weights drawn at a std that spreads the
    logits over several units, so conv-order noise reorders no ties."""
    rng = np.random.RandomState(seed)
    params = dict(variables['params'])
    for name, std in (('cls_head_8', 1.0), ('box_head_8', 0.2)):
        kernel = params[name]['kernel']
        params[name] = dict(params[name], kernel=(
            rng.randn(*kernel.shape) * std).astype(np.float32))
    return dict(variables, params=params)


def _by_class_score(scores, boxes, classes):
    keep = scores > 0
    s, b, c = scores[keep], boxes[keep], classes[keep]
    order = np.lexsort((-s, c))
    return s[order], b[order], c[order]


def _assert_detections_close(got, want, at_least=10):
    """Matched by (class, score): scores atol 1e-5, boxes atol 1e-2 px
    (``test_inference_fn_u8_matches_jax``'s tolerances)."""
    g, w = _by_class_score(*got), _by_class_score(*want)
    assert len(g[0]) == len(w[0]) > at_least
    np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-2)


def test_inference_fn_yuv_matches_jax(variables):
    """The whole slice on the yuv420 eval feed (assembly, normalize,
    backbone, FPN, heads, decode, NMS) on the same weights, fp32,
    threshold 0.001."""
    spread = _spread_heads(variables)
    config = {'threshold': 0.001}
    rng = np.random.RandomState(1)
    y, c = _planes(rng, 2, 128, 128)
    sizes = np.asarray([[128, 128], [100, 120]], np.float32)
    want = jax.jit(JaxModel('ResNet18FPN', classes=CLASSES,
                            config=config).inference_fn_yuv)(
        spread, y, c, sizes)
    got = _port(spread, config).inference_fn_yuv(_t(y), _t(c), _t(sizes))
    for i in range(2):
        _assert_detections_close([t[i].numpy() for t in got],
                                 [np.asarray(t[i]) for t in want])


def _json_detections(path):
    with open(path) as f:
        dets = json.load(f)['annotations']
    out = {}
    for d in dets:
        out.setdefault(d['image_id'], []).append(d)
    return {k: (np.asarray([d['score'] for d in v]),
                np.asarray([d['bbox'] for d in v]),
                np.asarray([d['category_id'] for d in v]))
            for k, v in out.items()}


def test_infer_on_yuv420_eval_feed_matches_jax(variables, dataset, tmp_path,
                                               monkeypatch):
    """``infer`` with ``ODTK_EVAL_FEED=yuv420`` on one checkpoint in both
    packages, fp32, threshold 0.001: each image's detections matched by
    (class, score) within the tolerances above."""
    img_dir, _ = dataset
    ckpt = str(tmp_path / 'model.pth')
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES,
                      config={'threshold': 0.001})
    jmodel.variables = _spread_heads(variables)
    jmodel.save({'path': ckpt})
    monkeypatch.setenv('ODTK_EVAL_FEED', 'yuv420')
    jmodel, _ = jax_checkpoint.load(ckpt)
    jmodel.threshold = 0.001
    jax_infer.infer(jmodel, img_dir, [str(tmp_path / 'jax.json')], 96, 128,
                    2, mixed_precision=False, verbose=False)
    model, _ = Model.load(ckpt)
    model.threshold = 0.001
    port_infer.infer(model, img_dir, str(tmp_path / 'port.json'), 96, 128,
                     2, mixed_precision=False, verbose=False, device='cpu')
    got = _json_detections(tmp_path / 'port.json')
    want = _json_detections(tmp_path / 'jax.json')
    assert sorted(got) == sorted(want) and len(got) == 5
    for image_id in want:
        _assert_detections_close(got[image_id], want[image_id])
