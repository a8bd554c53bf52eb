"""odtk_tpu_torch's training path held against the JAX package on the CPU.

Inputs are made by numpy from seeds and handed to both; everything runs
in fp32. Each test states its tolerance and why. The Pallas kernels of
the JAX side run in interpret mode, as the JAX package's own tests run
them on the CPU.
"""

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

from odtk_tpu.io import checkpoint as jax_checkpoint
from odtk_tpu.io.torch_import import variables_to_state_dict
from odtk_tpu.model import Model as JaxModel
from odtk_tpu.ops import assign as jax_assign
from odtk_tpu.ops import boxes as jax_boxes
from odtk_tpu.ops import color as jax_color
from odtk_tpu.ops.pallas.focal_kernel import detection_loss_sums_fused
from odtk_tpu.ops.pallas.stem_kernel import fused_bn_relu_pool
from odtk_tpu.parallel import make_mesh, shard_batch
from odtk_tpu import train as jax_train
from odtk_tpu_torch import main as cli
from odtk_tpu_torch import train as port_train
from odtk_tpu_torch.data import DataIterator
from odtk_tpu_torch.io.jax_bridge import state_dict_from_jax
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops import (apply_color_affine, box2delta, delta2box,
                                generate_anchors, snap_to_anchors)
from odtk_tpu_torch.ops.kernels import loss as kloss
from odtk_tpu_torch.ops.kernels import stem as kstem

from synth import make_dataset
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_boxes(rng, n, lo=0, hi=120):
    xy = rng.uniform(lo, hi - 30, (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ----------------------------------------------------------------- boxes
def test_box_codecs_match_jax():
    """box2delta / delta2box on the same boxes and anchors: fp32
    elementwise chains in the same order, rtol 1e-6."""
    rng = np.random.RandomState(0)
    boxes, anchors = _random_boxes(rng, 500), _random_boxes(rng, 500)
    deltas = rng.randn(500, 4).astype(np.float32)
    np.testing.assert_allclose(
        box2delta(_t(boxes), _t(anchors)).numpy(),
        np.asarray(jax_boxes.box2delta(boxes, anchors)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        delta2box(_t(deltas), _t(anchors), (20, 16), 8).numpy(),
        np.asarray(jax_boxes.delta2box(deltas, anchors, (20, 16), 8)),
        rtol=1e-6, atol=1e-4)


# ------------------------------------------------------------ assignment
def _targets(rng, b, m, n_live, size=128, ties=False):
    """[b, m, 5] (x, y, w, h, class) rows, -1-padded after n_live[i]."""
    t = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        k = n_live[i]
        xy = rng.uniform(0, size - 40, (k, 2))
        wh = rng.uniform(6, 70, (k, 2))
        t[i, :k, :2], t[i, :k, 2:4] = xy, wh
        t[i, :k, 4] = rng.randint(0, CLASSES, k)
        if ties and k >= 2:             # the same box twice, two classes
            t[i, 1, :4] = t[i, 0, :4]
            t[i, 1, 4] = (t[i, 0, 4] + 1) % CLASSES
    return t


@pytest.mark.parametrize('case', ['padded', 'empty', 'ties'])
@pytest.mark.parametrize('stride', [8, 32])
def test_assignment_matches_jax(case, stride):
    """snap_to_anchors on a batch against the JAX function per image
    (flat, index-form). Depth and the foreground class must be equal
    (the first-max tie-break included); deltas within 1e-5 (the same
    fp32 ops, another compiler)."""
    rng = np.random.RandomState({'padded': 1, 'empty': 2, 'ties': 3}[case])
    n_live = {'padded': [3, 1], 'empty': [0, 0], 'ties': [4, 2]}[case]
    targets = _targets(rng, 2, 6, n_live, ties=case == 'ties')
    size = (128, 96)
    table = generate_anchors(stride, [1.0, 2.0, 0.5],
                             [4 * 2 ** (i / 3) for i in range(3)])
    cls, deltas, depth = snap_to_anchors(_t(targets), size, stride, table,
                                         CLASSES)
    for i in range(2):
        w_cls, w_box, w_depth = jax_assign.snap_to_anchors(
            jnp.asarray(targets[i]), size, stride, table, CLASSES,
            one_hot_cls=False, flat=True)
        w_depth = np.asarray(w_depth).reshape(-1)
        w_cls = np.asarray(w_cls).reshape(-1)
        w_box = np.asarray(w_box).reshape(4, -1).T       # planar -> [N, 4]
        np.testing.assert_array_equal(depth[i].numpy(), w_depth)
        fg = w_depth > 0
        np.testing.assert_array_equal(cls[i].numpy()[fg], w_cls[fg])
        np.testing.assert_allclose(deltas[i].numpy(), w_box, rtol=1e-5,
                                   atol=1e-5)
    if case == 'empty':
        assert (depth == 0).all()
    elif stride == 8:                   # anchors of the boxes' sizes
        assert (depth > 0).any() and (depth == -1).any()


# ------------------------------------------------------------------ loss
def _loss_inputs(rng, b=2, h=4, w=6, anchors=9, k=CLASSES):
    n = h * w * anchors
    x = (rng.randn(b, h, w, anchors * k) * 3).astype(np.float32)
    bx = (rng.randn(b, h, w, anchors * 4) * 0.3).astype(np.float32)
    cls = rng.randint(0, k, (b, n))
    depth = rng.choice([-1.0, 0.0, 0.0], (b, n))
    fg = rng.rand(b, n) < 0.1
    depth[fg] = cls[fg] + 1
    box_t = (rng.randn(b, n, 4) * 0.3).astype(np.float32)
    return x, bx, cls.astype(np.int32), box_t, depth.astype(np.float32)


def test_loss_matches_jax_fused_kernel():
    """The plain loss (the port's CPU path) against
    detection_loss_sums_fused in interpret mode: the sums at rtol 1e-5
    (summation order), the gradients through jax.grad at rtol 1e-4 of
    each tensor's largest entry (closed form vs autograd)."""
    x, bx, cls, box_t, depth = _loss_inputs(np.random.RandomState(5))

    def jax_total(x_, bx_):
        c, b = detection_loss_sums_fused(
            x_, bx_, jnp.asarray(cls, jnp.float32), jnp.asarray(box_t),
            jnp.asarray(depth), classes=CLASSES, interpret=True)
        return c + 2.0 * b, (c, b)

    (_, (w_c, w_b)), (w_dx, w_dbx) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                 jnp.asarray(bx))
    xt = _t(x).requires_grad_(True)
    bxt = _t(bx).requires_grad_(True)
    c, b = kloss.detection_loss_sums(xt, bxt, _t(cls), _t(box_t),
                                     _t(depth), CLASSES)
    dx, dbx = torch.autograd.grad(c + 2.0 * b, (xt, bxt))
    np.testing.assert_allclose(c.item(), float(w_c), rtol=1e-5)
    np.testing.assert_allclose(b.item(), float(w_b), rtol=1e-5)
    for got, want in ((dx, w_dx), (dbx, w_dbx)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------------ stem
def test_stem_gradient_matches_jax_kernel():
    """The port's stem under autograd against fused_bn_relu_pool in
    interpret mode under jax.vjp. The NCHW conv output is handed to JAX
    in its merged even/odd-column layout [B, Hc, Wp, 2C]; Hp = 8 is a
    multiple of 4. Outputs within 1e-6 (XLA contracts the BN affine
    into a fused multiply-add, the port rounds the product first); the
    gradient routes each cotangent to the same first max, so it is
    equal up to the same rounding."""
    rng = np.random.RandomState(6)
    b, c, hc, wc = 2, 8, 16, 12
    y = rng.randn(b, c, hc, wc).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = rng.randn(c).astype(np.float32)
    g = rng.randn(b, c, hc // 2, wc // 2).astype(np.float32)

    merged = y.transpose(0, 2, 3, 1).reshape(b, hc, wc // 2, 2 * c)
    out, vjp = jax.vjp(
        lambda y_: fused_bn_relu_pool(y_, jnp.asarray(scale),
                                      jnp.asarray(shift), interpret=True),
        jnp.asarray(merged))
    dmerged, = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    want_out = np.asarray(out).transpose(0, 3, 1, 2)
    want_dy = np.asarray(dmerged).reshape(b, hc, wc, c).transpose(0, 3, 1, 2)

    yt = _t(y).requires_grad_(True)
    got = kstem.bn_relu_pool_train(yt, _t(scale), _t(shift))
    dy, = torch.autograd.grad(got, yt, _t(g))
    np.testing.assert_allclose(got.detach().numpy(), want_out, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), want_dy, rtol=1e-6, atol=1e-6)
    assert (dy != 0).sum() == (want_dy != 0).sum() > 0


# ----------------------------------------------------------------- color
def test_color_affine_matches_jax():
    """The u8 feed's per-image affine, clip and pad mask: the same three
    fp32 multiply-adds, atol 1e-6."""
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    colors = (rng.randn(2, 3, 4) * 0.02).astype(np.float32)
    colors[:, :, 3] = rng.randn(2, 3)
    sizes = np.asarray([[16, 24], [10, 15]], np.float32)
    got = apply_color_affine(_t(u8), _t(colors), _t(sizes)).numpy()
    want = np.asarray(jax_color.apply_color_affine(u8, colors, sizes))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[1, 10:] == 0).all() and (got[1, :, 15:] == 0).all()


# ------------------------------------------------- model, step, schedule
@pytest.fixture(scope='module')
def variables():
    """ResNet18FPN (4 classes) JAX variables with the frozen batch-norm
    statistics drawn by numpy, so the stem's scale is not 1."""
    model = JaxModel('ResNet18FPN', classes=CLASSES)
    v = jax.tree.map(np.asarray, model.initialize(rng=0,
                                                  image_size=(128, 128)))
    rng = np.random.RandomState(8)

    def draw(path, leaf):
        name = path[-1].key
        if name == 'var':
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if name == 'scale':
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    v['frozen'] = jax.tree_util.tree_map_with_path(draw, v['frozen'])
    return v


def _port(variables):
    model = Model('ResNet18FPN', classes=CLASSES)
    model.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope='module')
def batch(tmp_path_factory):
    """One u8 training batch of the port's loader (held equal to the
    JAX package's by tests/test_torch_data.py)."""
    root = tmp_path_factory.mktemp('torch_train')
    img_dir, ann = make_dataset(str(root), n_images=2, size=(100, 120),
                                seed=9, fmt='jpg')
    it = DataIterator(img_dir, 96, 128, 2, 128, 1, ann, training=True,
                      max_det=8, seed=1, num_threads=1, emit='u8',
                      augment_brightness=0.05, augment_contrast=0.05)
    random.seed(2)
    return next(iter(it))


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


def test_loss_fn_and_gradients_match_jax(variables, batch):
    """Model.loss_fn on ResNet18FPN (4 classes, bridged weights, fp32)
    against the JAX Model.loss_fn: both losses at rtol 1e-4, and every
    parameter's gradient within 1e-3 of its largest entry (convolutions
    and the loss sum in other orders, through 20 layers)."""
    images = np.asarray(jax_color.apply_color_affine(batch[0], batch[2],
                                                     batch[3]))
    targets = batch[1]
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES)

    def f(p):
        cl, bl = jmodel.loss_fn({'params': p, 'frozen': variables['frozen']},
                                images, targets)
        return cl + bl, (cl, bl)

    (_, (w_cl, w_bl)), w_g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables['params'])

    model = _port(variables)
    cl, bl = model.loss_fn(_t(images), _t(targets))
    (cl + bl).backward()
    np.testing.assert_allclose(cl.item(), float(w_cl), rtol=1e-4)
    np.testing.assert_allclose(bl.item(), float(w_bl), rtol=1e-4)
    got = {k: p.grad for k, p in model.module.named_parameters()}
    want = {k: v for k, v in _by_name(w_g, variables).items() if k in got}
    assert sorted(want) == sorted(got)
    assert float(got['backbones.ResNet18FPN.features.conv1.weight']
                 .abs().sum()) > 0
    _assert_tensors_close(got, want, 1e-3)


LR, WARMUP, MILESTONES, GAMMA, WD = 0.01, 10, [100, 200], 0.1, 1e-4


@pytest.fixture(scope='module')
def jax_steps(variables, batch):
    """The JAX u8 train step from the bridged weights: one real step,
    then a step on non-finite colours. Returns host copies."""
    jmodel = JaxModel('ResNet18FPN', classes=CLASSES)
    tx = jax_train.make_optimizer(LR, WARMUP, MILESTONES, GAMMA, WD)
    mesh = make_mesh(jax.devices()[:1])
    step = jax_train.make_train_step(jmodel, tx, mesh, feed='u8')
    params = variables['params']
    u8, targets, colors, sizes = batch
    args = shard_batch(mesh, u8, colors, sizes, targets)
    p1, o1, cl, bl = step(params, tx.init(params), variables['frozen'],
                          *args)
    p1, o1 = jax.device_get(p1), jax.device_get(o1)
    bad = np.full_like(colors, np.nan)
    args = shard_batch(mesh, u8, bad, sizes, targets)
    p2, o2, _, _ = step(p1, o1, variables['frozen'], *args)
    return dict(p1=p1, o1=o1, loss=(float(cl), float(bl)),
                p2=jax.device_get(p2), o2=jax.device_get(o2))


def _port_step(variables, batch):
    model = _port(variables)
    opt = port_train.make_optimizer(model.module.parameters(), LR, WD)
    step = port_train.make_train_step(model, opt, feed='u8')
    schedule = port_train.lr_schedule(LR, WARMUP, MILESTONES, GAMMA)
    params = dict(model.module.named_parameters())
    return model, opt, step, schedule, params


def test_u8_train_step_matches_jax(variables, batch, jax_steps):
    """One u8-feed SGD step (momentum 0.9, weight decay 1e-4, warmup lr)
    from the same weights and batch: the losses at rtol 1e-4; the
    parameter change and the momentum buffers (optax's trace, mapped by
    name) within 1e-3 of each tensor's largest entry; the change also
    within two fp32 ulps of the tensor's largest parameter, the rounding
    of p - lr * mu at this small warmup lr."""
    model, opt, step, schedule, params = _port_step(variables, batch)
    before = {k: p.detach().clone() for k, p in params.items()}
    cl, bl = step(schedule(0), *(_t(a) for a in batch))
    np.testing.assert_allclose([cl.item(), bl.item()], jax_steps['loss'],
                               rtol=1e-4)
    want_p = _by_name(jax_steps['p1'], variables)
    want_mu = _by_name(jax_steps['o1'][1].trace, variables)
    got_delta = {k: p.detach() - before[k] for k, p in params.items()}
    want_delta = {k: (want_p[k] - before[k]).numpy() for k in params}
    ulps = {k: 2 * float(np.spacing(np.abs(p.numpy()).max()))
            for k, p in before.items()}
    _assert_tensors_close(got_delta, want_delta, 1e-3, ulps)
    got_mu = {k: opt.state[p]['momentum_buffer'] for k, p in params.items()}
    _assert_tensors_close(got_mu, {k: want_mu[k] for k in params}, 1e-3)
    assert float(np.abs(want_delta[
        'backbones.ResNet18FPN.features.conv1.weight']).max()) > 0


def test_non_finite_step_is_skipped(variables, batch, jax_steps):
    """A step on NaN colours leaves the parameters and the momentum
    exactly as they were, in the port as in the JAX step."""
    for key in ('p1', 'p2'):
        assert all(np.isfinite(v).all()
                   for v in jax.tree.leaves(jax_steps[key]))
    jax.tree.map(np.testing.assert_array_equal, jax_steps['p2'],
                 jax_steps['p1'])
    jax.tree.map(np.testing.assert_array_equal, jax_steps['o2'][1].trace,
                 jax_steps['o1'][1].trace)

    model, opt, step, schedule, params = _port_step(variables, batch)
    u8, targets, colors, sizes = (_t(a) for a in batch)
    step(schedule(0), u8, targets, colors, sizes)
    kept = {k: p.detach().clone() for k, p in params.items()}
    mu = {k: opt.state[p]['momentum_buffer'].clone()
          for k, p in params.items()}
    cl, bl = step(schedule(1), u8, targets, torch.full_like(colors, np.nan),
                  sizes)
    assert not np.isfinite(cl.item() + bl.item())
    for k, p in params.items():
        assert torch.equal(p.detach(), kept[k]), k
        assert torch.equal(opt.state[p]['momentum_buffer'], mu[k]), k


def test_lr_schedule_matches_jax():
    """At 0, at warmup (still warmup: it <= warmup), warmup + 1, and at
    and around each milestone; rtol 1e-6 (JAX computes in fp32)."""
    got = port_train.lr_schedule(LR, WARMUP, MILESTONES, GAMMA)
    want = jax_train.lr_schedule(LR, WARMUP, MILESTONES, GAMMA)
    its = [0, 1, WARMUP - 1, WARMUP, WARMUP + 1, 99, 100, 101, 199, 200,
           201, 1000]
    np.testing.assert_allclose([got(i) for i in its],
                               [float(want(jnp.float32(i))) for i in its],
                               rtol=1e-6)
    assert got(WARMUP) == pytest.approx(LR)
    assert got(100) == pytest.approx(LR * GAMMA)
    no_warmup = port_train.lr_schedule(LR, 0, MILESTONES, GAMMA)
    assert no_warmup(0) == LR and no_warmup(250) == pytest.approx(LR / 100)


def test_fine_tune_copies_all_but_the_class_conv(tmp_path):
    donor = Model('ResNet18FPN', classes=CLASSES).initialize(1)
    path = str(tmp_path / 'donor.pth')
    donor.save({'path': path})
    fresh = Model('ResNet18FPN', classes=CLASSES).initialize(2)
    tuned = Model('ResNet18FPN', classes=CLASSES).initialize(
        2, fine_tune=path)
    d, f, t = (m.module.state_dict() for m in (donor, fresh, tuned))
    for k in t:
        want = f[k] if k.startswith('cls_head.8.') else d[k]
        assert torch.equal(t[k], want), k
    assert not torch.equal(d['cls_head.8.weight'], f['cls_head.8.weight'])


# ------------------------------------------------------------------- CLI
_CLI_RUN = r'''
import json, random, sys
sys.path.insert(0, {tests!r})
from synth import make_dataset
before = set(sys.modules)
from odtk_tpu_torch import main as cli
img, ann = make_dataset({root!r}, n_images=4, size=(96, 128), fmt='jpg')
random.seed(0)
common = ['--images', img, '--annotations', ann, '--batch', '2',
          '--resize', '96', '--max-size', '128', '--device', 'cpu']
train = cli.main(['train', {ckpt!r}, '--backbone', 'ResNet18FPN',
                  '--classes', '3', '--jitter', '96', '112', '--iters', '2',
                  '--warmup', '1', '--milestones', '1', '--full-precision',
                  '--no-pretrained'] + common)
result = cli.main(['infer', {ckpt!r}, '--output', {det!r},
                   '--threshold', '0.001'] + common)
mods = {{m.split('.')[0] for m in set(sys.modules) - before}}
print(json.dumps({{'losses': train['losses'],
                  'stats': None if result['stats'] is None
                  else [float(s) for s in result['stats']],
                  'leaked': sorted(mods & {{'odtk_tpu', 'jax', 'jaxlib',
                                            'flax', 'optax'}}),
                  'loaded': sorted(m for m in ('odtk_tpu', 'jax')
                                   if m in sys.modules)}}))
'''


def test_cli_train_then_infer_without_jax(tmp_path):
    """``odtk-tpu-torch train`` on the CPU writes a .pth that
    ``odtk-tpu-torch infer`` scores and ``odtk_tpu.io.checkpoint.load``
    reads; the run imports nothing of JAX or of odtk_tpu."""
    ckpt = str(tmp_path / 'model.pth')
    code = _CLI_RUN.format(tests=os.path.join(REPO, 'tests'),
                           root=str(tmp_path), ckpt=ckpt,
                           det=str(tmp_path / 'det.json'))
    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report['leaked'] == [] and report['loaded'] == []
    assert [it for it, _, _ in report['losses']] == [0, 1]
    assert all(np.isfinite(report['losses']).all() for _ in [0])
    assert report['stats'] is not None and len(report['stats']) == 12

    port, state = Model.load(ckpt)
    assert state['iteration'] == 2
    assert state['scheduler'] == {'last_iter': 2}
    assert set(state['optimizer']) == {'state', 'param_groups'}
    restored, jstate = jax_checkpoint.load(ckpt)
    assert jstate['iteration'] == 2 and restored.classes == 3
    sd = variables_to_state_dict(restored.variables)
    for k, v in port.module.state_dict().items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy(),
                                      err_msg=k)


def test_resume_from_jax_checkpoint_starts_momentum_fresh(tmp_path):
    """A .pth written by the JAX package carries an optax blob the port
    cannot read: training resumes from its iteration with a warning."""
    img, ann = make_dataset(str(tmp_path), n_images=2, size=(96, 128),
                            fmt='jpg')
    jmodel = JaxModel('ResNet18FPN', classes=3)
    jmodel.initialize(rng=0, image_size=(128, 128))
    path = str(tmp_path / 'jax.pth')
    jmodel.save({'path': path, 'iteration': 4,
                 'optimizer': {'mu': np.arange(3.0, dtype=np.float32)}})
    model, state = Model.load(path)
    state['path'] = path
    with pytest.warns(UserWarning, match='starting the momentum fresh'):
        out = port_train.train(
            model, state, img, ann, img, None, 96, 128, [96, 96], 2, 5, 0,
            0.01, 0, [], 0.1, mixed_precision=False, verbose=False,
            device='cpu')
    assert [it for it, _, _ in out['losses']] == [4]
    _, resumed = Model.load(path)
    assert resumed['iteration'] == 5
    assert isinstance(resumed['optimizer'], dict)
