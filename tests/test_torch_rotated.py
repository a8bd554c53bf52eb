"""odtk_tpu_torch's rotated-box geometry, matchers, assignment and loss
held against the JAX package on the CPU.

Inputs are made by numpy from seeds and handed to both packages; the
model runs in fp32. The Pallas kernels of the JAX side run in interpret
mode, as the JAX package's own tests run them on the CPU. Each test
states its tolerance and why. The polygon IoUs of the two packages are
the same operations in the same order, but XLA on the CPU may contract a
multiply and an add into one fused multiply-add where PyTorch rounds
both, so IoUs agree to ~1e-5, not bit for bit: the data of the tests
whose decisions compare an IoU with a threshold keeps it more than 1e-4
away from it, and checks that it does.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops import anchors as jax_anchors
from odtk_tpu.ops import assign as jax_assign
from odtk_tpu.ops import boxes as jax_boxes
from odtk_tpu.ops import iou_rotated as jax_iou
from odtk_tpu.ops.pallas.focal_kernel import detection_loss_sums_fused
from odtk_tpu.ops.pallas.iou_kernel import rotated_best_match_pallas
from odtk_tpu_torch.ops import (box2delta_rotated,
                                delta2box_rotated, generate_anchors_rotated,
                                order_points, rotate_boxes,
                                snap_to_anchors_rotated,
                                snap_to_anchors_rotated_batched)
from odtk_tpu_torch.ops import iou_rotated
from odtk_tpu_torch.ops.kernels import loss as kloss
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3
RATIOS = [1.0, 2.0, 0.5]
SCALES = [4 * 2 ** (i / 3) for i in range(3)]
ANGLES = [-np.pi / 6, 0, np.pi / 6]


def _t(a):
    return torch.from_numpy(np.array(a))


def _sincos_boxes(rng, n, lo=10, hi=110):
    """(x1, y1, x2, y2, sin, cos) boxes [n, 6] fp32."""
    ctr = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(6, 50, (n, 2))
    th = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return np.concatenate([ctr - wh / 2, ctr + wh / 2, np.sin(th)[:, None],
                           np.cos(th)[:, None]], 1).astype(np.float32)


def _corners(boxes):
    return iou_rotated.sincos_box_corners(_t(boxes)).numpy()


def _rotated_targets(rng, b, m, n_live, size=128):
    """[b, m, 6] (x, y, w, h, theta, class) rows, -1-padded after
    n_live[i]."""
    t = np.full((b, m, 6), -1.0, np.float32)
    for i, k in enumerate(n_live):
        t[i, :k, :2] = rng.uniform(0, size - 40, (k, 2))
        t[i, :k, 2:4] = rng.uniform(8, 70, (k, 2))
        t[i, :k, 4] = rng.uniform(-np.pi / 4, np.pi / 4, k)
        t[i, :k, 5] = rng.randint(0, CLASSES, k)
    return t


@pytest.fixture(scope='module', autouse=True)
def _one_target_per_stream_step():
    """The JAX stream's chunk only sets how many targets one step of its
    while loop clips; at 1 the graph it compiles is 8x smaller and the
    fold gives the same maxima."""
    patch = pytest.MonkeyPatch()
    patch.setenv('ODTK_ROTATED_CHUNK', '1')
    yield
    patch.undo()


def _assert_far_from(values, cuts, margin=1e-4):
    values = np.asarray(values)
    for cut in cuts:
        assert np.abs(values - cut).min() > margin, \
            f'test data has a value within {margin} of {cut}'


# --------------------------------------------------------------- anchors
@pytest.mark.parametrize('stride', [8, 16, 32, 64, 128])
def test_generate_anchors_rotated_matches_jax(stride):
    """The numpy copy: the (axis, corners) pair equal to the original."""
    got = generate_anchors_rotated(stride, RATIOS, SCALES, ANGLES)
    want = jax_anchors.generate_anchors_rotated(stride, RATIOS, SCALES,
                                                ANGLES)
    assert got[0].shape == (27, 4) and got[1].shape == (27, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize('case', ['random', 'tied_x'])
def test_order_points_matches_jax(case):
    """Equal corner order, ties of x included (both sorts stable): the
    points are permutations of the input, so equal bit for bit."""
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 100, (200, 4, 2)).astype(np.float32)
    if case == 'tied_x':          # axis-aligned rectangles: x tied in pairs
        pts = np.round(pts)
        pts[:, 1, 0] = pts[:, 0, 0]
        pts[:, 3, 0] = pts[:, 2, 0]
    got = order_points(_t(pts)).numpy()
    want = np.asarray(jax_boxes.order_points(jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('points', [False, True])
def test_rotate_boxes_matches_jax(points):
    """Both forms: the axis-aligned + (sin, cos) boxes and the ordered
    corners within 1e-4 px (cos and sin of the two libraries may differ
    in the last ulp, times coordinates of ~100)."""
    rng = np.random.RandomState(2)
    boxes = np.concatenate([rng.uniform(0, 100, (300, 4)),
                            rng.uniform(-1.5, 1.5, (300, 1))],
                           1).astype(np.float32)
    got = rotate_boxes(_t(boxes), points=points)
    want = jax_boxes.rotate_boxes(jnp.asarray(boxes), points=points)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_rotated_box_codecs_match_jax():
    """box2delta_rotated and delta2box_rotated: fp32 elementwise chains
    in the same order; sin and cos pass through exactly."""
    rng = np.random.RandomState(3)
    boxes, anchors = _sincos_boxes(rng, 400), _sincos_boxes(rng, 400)[:, :4]
    deltas = rng.randn(400, 6).astype(np.float32)
    got = box2delta_rotated(_t(boxes), _t(anchors)).numpy()
    want = np.asarray(jax_boxes.box2delta_rotated(boxes, anchors))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, 4:], boxes[:, 4:])
    got = delta2box_rotated(_t(deltas), _t(anchors), (20, 16), 8).numpy()
    want = np.asarray(jax_boxes.delta2box_rotated(deltas, anchors,
                                                  (20, 16), 8))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got[:, 4:], deltas[:, 4:])


# ------------------------------------------------------------------ IoU
def _iou_case(case):
    rng = np.random.RandomState(4)
    subj = _corners(_sincos_boxes(rng, 300))
    clip = subj[7].copy()
    if case == 'identical':
        subj[:50] = clip
    elif case == 'disjoint':
        subj[:, 0::2] += 500.0
    elif case == 'coincident':      # shared corner coordinates: the pad
        subj[:100, 0] = clip[0]
        subj[100:200, 3] = clip[3]
        subj[200:, 4:6] = clip[4:6]
    return subj, clip


@pytest.mark.parametrize('case', ['random', 'identical', 'disjoint',
                                  'coincident'])
def test_quad_iou_one_vs_all_matches_jax(case):
    """IoU of 300 quads vs one: within 1e-5 (XLA may contract an FMA);
    an identical quad gives ~1 (the pad), a disjoint one 0."""
    subj, clip = _iou_case(case)
    got = iou_rotated.quad_iou_one_vs_all(_t(subj), _t(clip)).numpy()
    want = np.asarray(jax_iou.quad_iou_one_vs_all(jnp.asarray(subj),
                                                  jnp.asarray(clip)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == 'identical':
        assert (got[:50] > 0.999).all()
    elif case == 'disjoint':
        assert (got == 0).all()
    elif case == 'random':
        assert (got > 0).sum() > 20


def test_quad_iou_nan_rules_match_jax():
    """A subject edge on the last clip edge's line (parallel, no pad):
    its crossing is 0/0 and kept, so inter is NaN and the IoU 0; with an
    infinite corner as well the area is NaN too, and the IoU 1. A NaN
    subject clips to nothing: inter 0, union NaN, IoU NaN. As in JAX."""
    clip = np.asarray([0, 0, 10, 0, 10, 10, 0, 10], np.float32)
    subj = np.asarray([[5, 2, 0, 2, 0, 8, 5, 8],
                       [5, 2, 0, 2, 0, 8, np.inf, 8],
                       [np.nan] * 8,
                       [2, 2, 8, 2, 8, 8, 2, 8]], np.float32)
    got = iou_rotated.quad_iou_one_vs_all(_t(subj), _t(clip)).numpy()
    want = np.asarray(jax_iou.quad_iou_one_vs_all(jnp.asarray(subj),
                                                  jnp.asarray(clip)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], [0.0, 1.0, np.nan])
    np.testing.assert_allclose(got[3], 0.36, rtol=1e-6)


def _anchor_quads(stride=8, size=(96, 64)):
    table = generate_anchors_rotated(stride, RATIOS, SCALES, ANGLES)
    w, h = size[0] // stride, size[1] // stride
    from odtk_tpu_torch.ops.assign import level_anchors
    return level_anchors(w, h, stride, table[1], 'cpu').numpy()


def test_rotated_best_match_matches_jax_and_pallas():
    """The unbatched matcher (every target visited, an invalid one -1)
    against the jnp form: IoUs within 1e-5, the same index wherever the
    best is unique by more than 1e-4. Against rotated_best_match_pallas
    in interpret mode (tile-AABB skip, invalid targets skipped, -2
    sentinel): the same wherever its best IoU is > 0."""
    rng = np.random.RandomState(5)
    anchors = _anchor_quads()
    t = _rotated_targets(rng, 1, 10, [7], size=96)[0]
    _, quads = rotate_boxes(_t(t[:, :5]))
    valid = t[:, 5] > -1
    got_iou, got_idx = iou_rotated.rotated_best_match(_t(anchors), quads,
                                                      _t(valid))
    w_iou, w_idx = jax_iou.rotated_best_match(
        jnp.asarray(anchors), jnp.asarray(quads.numpy()), jnp.asarray(valid))
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(w_iou), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(w_idx))
    assert (got_iou > 0.5).any() and (got_iou == -1).sum() == 0
    p_iou, p_idx = rotated_best_match_pallas(
        jnp.asarray(anchors), jnp.asarray(quads.numpy()), jnp.asarray(valid),
        interpret=True)
    p_iou, p_idx = np.asarray(p_iou), np.asarray(p_idx)
    hit = p_iou > 0
    np.testing.assert_allclose(got_iou.numpy()[hit], p_iou[hit], atol=1e-5)
    np.testing.assert_array_equal(got_idx.numpy()[hit], p_idx[hit])
    assert (got_iou.numpy()[~hit] <= 0).all()


def test_rotated_best_match_batched_matches_jax_stream():
    """The batched matcher against the JAX stream, with padding rows, an
    empty image and targets outside the size band (skipped by both):
    IoUs within 1e-5, slots equal."""
    rng = np.random.RandomState(6)
    anchors = _anchor_quads()
    t = _rotated_targets(rng, 3, 8, [5, 0, 8], size=96)
    t[2, 6, 2:4] = [400, 300]           # far above the band
    t[2, 7, 2:4] = [1, 1]               # far below it
    _, quads = rotate_boxes(_t(t[..., :5]))
    valid = t[..., 5] > -1
    got_iou, got_slot = iou_rotated.rotated_best_match_batched(
        _t(anchors), quads, _t(valid), skip_ratio=0.4)
    w_iou, w_slot = jax_iou.rotated_best_match_batched(
        jnp.asarray(anchors), jnp.asarray(quads.numpy()), jnp.asarray(valid),
        skip_ratio=0.4, use_pallas=False)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(w_iou), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(w_slot))
    assert (got_iou[1] == -2).all() and (got_slot[2] != 6).all()
    assert (got_slot[2] != 7).all() and (got_iou[0] > 0.5).any()


def test_snap_to_anchors_rotated_batched_matches_jax():
    """Rotated assignment against the JAX batched function (flat,
    index-form): depth equal everywhere; cls and the 6 deltas equal on
    the foreground, deltas within 1e-5 (the same fp32 ops). The best
    IoUs keep 1e-4 away from lo and hi."""
    rng = np.random.RandomState(0)
    targets = _rotated_targets(rng, 2, 6, [4, 2])
    size, stride = (128, 96), 8
    table = generate_anchors_rotated(stride, RATIOS, SCALES, ANGLES)
    cls, deltas, depth = snap_to_anchors_rotated_batched(
        _t(targets), size, stride, table, CLASSES)
    w_cls, w_box, w_depth = jax_assign.snap_to_anchors_rotated_batched(
        jnp.asarray(targets), size=size, stride=stride, anchor_table=table,
        num_classes=CLASSES, one_hot_cls=False, flat=True)
    w_depth = np.asarray(w_depth).reshape(2, -1)
    w_cls = np.asarray(w_cls).reshape(2, -1)
    w_box = np.asarray(w_box).reshape(6, 2, -1).transpose(1, 2, 0)
    np.testing.assert_array_equal(depth.numpy(), w_depth)
    fg = w_depth > 0
    assert fg.any() and (w_depth == -1).any()
    np.testing.assert_array_equal(cls.numpy()[fg], w_cls[fg])
    np.testing.assert_allclose(deltas.numpy()[fg], w_box[fg], rtol=1e-5,
                               atol=1e-5)
    quads = rotate_boxes(_t(np.concatenate(
        [targets[..., :2], np.maximum(targets[..., 2:4], 1e-4),
         targets[..., 4:5]], -1)))[1]
    from odtk_tpu_torch.ops.assign import level_anchors
    best, _ = iou_rotated.rotated_best_match_batched(
        level_anchors(size[0] // stride, size[1] // stride, stride, table[1],
                      'cpu'), quads, _t(targets[..., 5] > -1),
        skip_ratio=0.4)
    _assert_far_from(best.numpy(), (0.4, 0.5))


def test_snap_to_anchors_rotated_unbatched_equals_batched():
    """The unbatched reference twin (row 8's matcher, nothing skipped)
    gives the batched assignment's depth everywhere and its cls and
    deltas on the foreground, image by image."""
    rng = np.random.RandomState(9)
    targets = _rotated_targets(rng, 2, 5, [3, 5])
    table = generate_anchors_rotated(8, RATIOS, SCALES, ANGLES)
    cls, deltas, depth = snap_to_anchors_rotated_batched(
        _t(targets), (128, 96), 8, table, CLASSES)
    for i in range(2):
        c1, d1, dp1 = snap_to_anchors_rotated(_t(targets[i]), (128, 96), 8,
                                              table, CLASSES)
        assert torch.equal(dp1, depth[i])
        fg = dp1 > 0
        assert fg.any()
        assert torch.equal(c1[fg], cls[i][fg])
        assert torch.equal(d1[fg], deltas[i][fg])


# ----------------------------------------------------------------- loss
def test_loss_plain_at_box_dim_6_matches_jax_fused_kernel():
    """detection_loss_sums_plain at D = 6, A = 27 against
    detection_loss_sums_fused (box_dim 6) in interpret mode: the sums at
    rtol 1e-5 (summation order), the gradients within 1e-4 of each
    tensor's largest entry (closed form vs autograd)."""
    rng = np.random.RandomState(12)
    b, h, w, a = 2, 3, 4, 27
    n = h * w * a
    x = (rng.randn(b, h, w, a * CLASSES) * 3).astype(np.float32)
    bx = (rng.randn(b, h, w, a * 6) * 0.3).astype(np.float32)
    cls = rng.randint(0, CLASSES, (b, n)).astype(np.int32)
    depth = rng.choice([-1.0, 0.0, 0.0], (b, n))
    fg = rng.rand(b, n) < 0.1
    depth[fg] = cls[fg] + 1
    depth = depth.astype(np.float32)
    box_t = (rng.randn(b, n, 6) * 0.3).astype(np.float32)

    def jax_total(x_, bx_):
        c, s = detection_loss_sums_fused(
            x_, bx_, jnp.asarray(cls, jnp.float32), jnp.asarray(box_t),
            jnp.asarray(depth), classes=CLASSES, interpret=True)
        return c + 2.0 * s, (c, s)

    (_, (w_c, w_b)), (w_dx, w_dbx) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                 jnp.asarray(bx))
    xt = _t(x).requires_grad_(True)
    bxt = _t(bx).requires_grad_(True)
    c, s = kloss.detection_loss_sums_plain(xt, bxt, _t(cls), _t(box_t),
                                           _t(depth), CLASSES)
    dx, dbx = torch.autograd.grad(c + 2.0 * s, (xt, bxt))
    np.testing.assert_allclose([c.item(), s.item()],
                               [float(w_c), float(w_b)], rtol=1e-5)
    for got, want in ((dx, w_dx), (dbx, w_dbx)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert (dbx.reshape(b, -1, 6)[_t(depth) <= 0] == 0).all()
