"""odtk_tpu_torch's CUDA kernels held against their plain PyTorch versions.

This file imports no JAX, so it also runs where JAX is not installed.
The tests marked ``cuda`` need a card and skip without one; on the card:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from odtk_tpu_torch.ops import (generate_anchors_rotated, rotate_boxes,
                                snap_to_anchors_rotated_batched,
                                snap_to_anchors_rotated_levels)
from odtk_tpu_torch.ops.assign import level_anchors
from odtk_tpu_torch.ops.iou_rotated import (pack_active, quad_areas,
                                            sincos_box_corners)
from odtk_tpu_torch.ops.kernels import _build
from odtk_tpu_torch.ops.kernels import conv_w8a8 as kconv
from odtk_tpu_torch.ops.kernels import focal as kfocal
from odtk_tpu_torch.ops.kernels import loss as kloss
from odtk_tpu_torch.ops.kernels import match_rotated as kmatch
from odtk_tpu_torch.ops.kernels import nms as knms
from odtk_tpu_torch.ops.kernels import nms_rotated as knms_rot
from odtk_tpu_torch.ops.kernels import stem as kstem
from rotated_cases import degenerate_case


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def nms_case(kind, b=2, n=300, seed=0):
    """Integer-coordinate boxes (areas and intersections exact in fp32)."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 200, (b, n, 2))
    wh = rng.randint(4, 60, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    scores[rng.rand(b, n) < 0.3] = 0.0
    classes = rng.randint(0, 4, (b, n)).astype(np.float32)
    if kind == 'ties':
        scores = np.where(scores > 0, np.ceil(scores * 8) / 8,
                          0).astype(np.float32)
    elif kind == 'iou_at_threshold':
        # 20x10 and 10x10 at one corner: inter 100 / union 200 = 0.5 exactly
        boxes[:, :3] = [[0, 0, 19, 9], [0, 0, 9, 9], [0, 0, 10, 9]]
        scores[:, :3] = [0.99, 0.98, 0.97]
        classes[:, :3] = 9          # a class of their own
    elif kind == 'zeros':
        scores[:] = 0.0
    elif kind == 'few_live':
        scores[:, 10:] = 0.0
    elif kind == 'nan_scores':
        scores[0, 17] = np.nan      # image 0 records nothing
        scores[1, 3] = -np.inf      # a dead candidate, not a NaN
    return scores, boxes, classes


def test_stem_plain_dtype_and_padding():
    """bf16 in, bf16 out; the pool's -inf padding never wins over a real
    post-ReLU value, so a window of negatives pools to 0."""
    y = -torch.rand(1, 2, 5, 7, dtype=torch.float32) - 1
    out = kstem.bn_relu_pool(y.bfloat16(), torch.ones(2), torch.zeros(2))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 3, 4)
    assert (out == 0).all()


# ------------------------------------------------------- kernels on card
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_stem_kernel_bit_equal_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    for shape in [(2, 64, 448, 576), (1, 64, 13, 9)]:
        y = torch.randn(shape, generator=g).to(cuda_device, dtype)
        scale = (torch.rand(64, generator=g) + 0.5).to(cuda_device)
        shift = torch.randn(64, generator=g).to(cuda_device)
        got = kstem.bn_relu_pool(y, scale, shift)
        torch.cuda.synchronize()
        assert torch.equal(got, kstem.bn_relu_pool_plain(y, scale, shift))


@pytest.mark.cuda
@pytest.mark.parametrize('kind,n', [('random', 2000), ('ties', 5000),
                                    ('iou_at_threshold', 4099),
                                    ('zeros', 1000), ('few_live', 8192),
                                    ('random', 8192), ('nan_scores', 2000),
                                    ('random', 1), ('random', 65)])
def test_nms_kernel_equals_plain(cuda_device, kind, n):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in nms_case(kind, n=n)]
    before = knms.nms.launches
    got = knms.nms(*args, 0.5, 100)
    torch.cuda.synchronize()
    assert knms.nms.launches == before + 1
    want = knms.nms_plain(*args, 0.5, 100)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if kind == 'nan_scores':
        assert not got[0][0].any() and got[0][1].any()


@pytest.mark.cuda
@pytest.mark.parametrize('thr,ndet', [(0.0, 100), (-1.0, 50), (0.3, 1000),
                                      (0.9, 7)])
def test_nms_kernel_thresholds_and_depths(cuda_device, thr, ndet):
    """Thresholds at and below 0 (every same-class pair suppresses), D past
    the live count, and D of a few."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in nms_case('ties', n=1500)]
    got = knms.nms(*args, thr, ndet)
    torch.cuda.synchronize()
    want = knms.nms_plain(*args, thr, ndet)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kernel_wrappers_reject_bad_input():
    meta = torch.zeros(1, 10, device='meta')
    with pytest.raises(ValueError):
        knms.nms(meta, torch.zeros(1, 10, 4, device='meta'), meta)
    with pytest.raises(ValueError):
        kstem.bn_relu_pool(torch.zeros(1, 2, 4, 4, device='meta'),
                           torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError):
        kconv.conv_w8a8(torch.zeros(1, 2, 4, 4, device='meta'),
                        torch.zeros(3, 1, 1, 16, dtype=torch.int8,
                                    device='meta'),
                        torch.ones(3, device='meta'),
                        torch.ones((), device='meta'), None, (1, 1), (0, 0),
                        1, torch.float32)


def test_nms_plain_semantics():
    """Zero-padded, score-descending; the box at IoU == 0.5 survives and
    the one above it does not; D beyond the live count pads with zeros."""
    s, b, c = (torch.from_numpy(a) for a in nms_case('iou_at_threshold'))
    out_s, out_b, out_c = knms.nms_plain(s, b, c, 0.5, 300)
    assert (out_s[:, :-1] >= out_s[:, 1:]).all()
    kept = out_s > 0
    assert (out_s[~kept] == 0).all() and (out_b[~kept] == 0).all()
    assert kept.sum(1).max() < 300
    assert (out_s[0] == 0.98).any() and not (out_s[0] == 0.97).any()


def test_build_compiles_every_source_for_sm90a():
    names = sorted(p.rsplit('/', 1)[-1] for p in _build.sources())
    assert names == ['conv_w8a8.cu', 'det_loss.cu', 'focal_sum.cu',
                     'match_rotated.cu', 'nms.cu', 'nms_rotated.cu',
                     'stem_pool.cu']
    assert [p.rsplit('/', 1)[-1] for p in _build.headers()] == [
        'focal.cuh', 'nms_scan.cuh', 'quad_iou.cuh']
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    assert not any('fast_math' in f for f in _build.NVCC_FLAGS)
    assert _build.library_path().startswith(_build.BUILD_DIR)


# ------------------------------------------------- stem under autodiff
def _stem_case(shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    y = torch.randn(shape, generator=g).to(device, dtype)
    scale = (torch.rand(c, generator=g) + 0.5).to(device)
    shift = torch.randn(c, generator=g).to(device)
    return y, scale, shift


def _pool_shape(shape):
    b, c, hc, wc = shape
    return (b, c, (hc - 1) // 2 + 1, (wc - 1) // 2 + 1)


def test_stem_plain_codes_route_like_autograd():
    """The plain codes (from max_pool2d's indices) routed by the plain
    backward equal the autograd of the plain forward exactly, with
    sentinel windows (all-negative) getting no gradient."""
    y, scale, shift = _stem_case((2, 3, 16, 12), torch.float32, 'cpu')
    y[0, 0, :4, :4] = -5.0
    y.requires_grad_(True)
    out = kstem.bn_relu_pool_plain(y, scale, shift)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    want, = torch.autograd.grad(out, y, g)
    out2, idx = kstem.bn_relu_pool_idx_plain(y.detach(), scale, shift)
    assert torch.equal(out.detach(), out2)
    assert idx.dtype == torch.int8 and int(idx.max()) <= 9
    assert (idx[out2 == 0] == 9).all() and (idx[out2 > 0] < 9).all()
    got = kstem.bn_relu_pool_bwd_plain(idx, g, scale, (16, 12))
    assert torch.equal(got, want)


def test_stem_under_grad_has_grad_fn_on_cpu():
    """A grad-enabled ResNet forward builds a graph through the stem, so
    conv1 trains; without grad it stays the primal forward."""
    from odtk_tpu_torch.backbones.resnet import ResNet
    net = ResNet(layers=(1, 1, 1, 1), bottleneck=False)
    x = torch.randn(1, 3, 64, 64)
    c3, c4, c5 = net(x)
    assert c5.grad_fn is not None
    c5.sum().backward()
    assert net.conv1.weight.grad is not None
    assert net.conv1.weight.grad.abs().sum() > 0
    with torch.no_grad():
        assert net(x)[2].grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_stem_idx_kernel_equals_plain(cuda_device, dtype):
    """Forward with argmax: out bit-equal to the primal kernel and the
    plain version; idx equal to max_pool2d's indices mapped to codes."""
    for shape in [(2, 64, 448, 576), (1, 64, 13, 9)]:
        y, scale, shift = _stem_case(shape, dtype, cuda_device)
        y[0, 0, :6, :6] = -3.0              # sentinel windows
        out, idx = kstem.bn_relu_pool_idx(y, scale, shift)
        torch.cuda.synchronize()
        want_out, want_idx = kstem.bn_relu_pool_idx_plain(y, scale, shift)
        assert torch.equal(out, kstem.bn_relu_pool(y, scale, shift))
        assert torch.equal(out, want_out)
        assert torch.equal(idx, want_idx)


def _off_grid(t):
    """A contiguous copy of t one element past an allocation's start, so
    off the 16-byte grid."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


# the train batch's conv1 shape; odd Hc and Wc with one group and with wp
# 10, not a multiple of 4 (the scalar loads and stores); 73 groups a
# plane, so a plane's groups straddle warps, and odd Hc (the last pooled
# row writes one conv row); even sizes at 16-byte rows
STEM_BWD_SHAPES = [(2, 64, 448, 576), (1, 64, 13, 9), (1, 3, 13, 9),
                   (2, 5, 17, 19), (1, 64, 449, 577), (2, 4, 40, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_stem_bwd_kernel_equals_plain_autograd(cuda_device, dtype):
    """The routing backward equals the autograd of the plain version:
    both sum the <= 4 routed cotangents in fp32 in ascending window
    order, then scale and round once. Again with the cotangent and the
    codes one element off the 16-byte grid (the scalar loads)."""
    for shape in STEM_BWD_SHAPES:
        y, scale, shift = _stem_case(shape, dtype, cuda_device, seed=2)
        g = torch.randn(_pool_shape(shape),
                        generator=torch.Generator().manual_seed(3))
        g = g.to(cuda_device, dtype)
        yr = y.clone().requires_grad_(True)
        got, = torch.autograd.grad(kstem.bn_relu_pool_train(yr, scale, shift),
                                   yr, g)
        torch.cuda.synchronize()
        want, = torch.autograd.grad(kstem.bn_relu_pool_plain(yr, scale, shift),
                                    yr, g)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        _, idx = kstem.bn_relu_pool_idx(y, scale, shift)
        off = kstem.bn_relu_pool_bwd(_off_grid(idx), _off_grid(g), scale,
                                     shape[2:])
        torch.cuda.synchronize()
        assert torch.equal(off, want)


def _stem_nan_case(shape, dtype, device, seed=4):
    """_stem_case with NaN planted in y (a corner included), and +-inf in
    the last channel, whose scale is 0 (inf * 0 = NaN), +inf and -inf in
    the others (an infinite window max, a ReLU zero)."""
    y, scale, shift = _stem_case(shape, torch.float32, 'cpu', seed)
    g = torch.Generator().manual_seed(seed + 1)
    y[torch.rand(shape, generator=g) < 0.01] = torch.nan
    y[0, 0, 0, 0] = torch.nan
    y[torch.rand(shape, generator=g) < 0.002] = torch.inf
    y[torch.rand(shape, generator=g) < 0.002] = -torch.inf
    scale[-1] = 0.0
    y[:, -1][torch.rand(y[:, -1].shape, generator=g) < 0.05] = torch.inf
    return y.to(device, dtype), scale.to(device), shift.to(device)


def _equal_nan(a, b):
    """Equal values (torch.equal's rule) with NaNs in the same places."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (a.isnan() & b.isnan())).all()))


def test_stem_plain_nan_rule():
    """A window that holds a NaN pools to NaN with the code 9, and the
    plain version's autograd routes it nothing, as the codes do (and the
    JAX package's VJP: tests/test_torch_stem_levels.py)."""
    y, scale, shift = _stem_nan_case((2, 3, 13, 9), torch.float32, 'cpu')
    out, idx = kstem.bn_relu_pool_idx_plain(y, scale, shift)
    assert out.isnan().any() and not out.isnan().all()
    assert (idx[out.isnan()] == kstem.SENTINEL).all()
    assert _equal_nan(kstem.bn_relu_pool(y, scale, shift), out)
    yr = y.clone().requires_grad_(True)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    want, = torch.autograd.grad(kstem.bn_relu_pool_train(yr, scale, shift),
                                yr, g)
    assert not want.isnan().any()
    assert torch.equal(want,
                       kstem.bn_relu_pool_bwd_plain(idx, g, scale, (13, 9)))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 64, 448, 576), (1, 3, 13, 9),
                                   (2, 5, 17, 19), (1, 64, 449, 577)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_stem_kernels_carry_nan(cuda_device, dtype, shape):
    """Rows 2, 3 and 4 on NaN-planted inputs: the forwards equal the plain
    version with NaNs in the same places, the codes equal the plain codes
    (9 wherever the output is NaN), and the routing backward equals the
    plain version's autograd."""
    y, scale, shift = _stem_nan_case(shape, dtype, cuda_device)
    got = kstem.bn_relu_pool(y, scale, shift)
    out, idx = kstem.bn_relu_pool_idx(y, scale, shift)
    torch.cuda.synchronize()
    want, want_idx = kstem.bn_relu_pool_idx_plain(y, scale, shift)
    assert want.isnan().any() and not want.isnan().all()
    assert _equal_nan(got, want) and _equal_nan(out, want)
    assert torch.equal(idx, want_idx)
    assert (idx[want.isnan()] == kstem.SENTINEL).all()
    g = torch.randn(_pool_shape(shape),
                    generator=torch.Generator().manual_seed(3))
    g = g.to(cuda_device, dtype)
    yr = y.clone().requires_grad_(True)
    dy, = torch.autograd.grad(kstem.bn_relu_pool_train(yr, scale, shift),
                              yr, g)
    torch.cuda.synchronize()
    want_dy, = torch.autograd.grad(kstem.bn_relu_pool_plain(yr, scale, shift),
                                   yr, g)
    assert torch.equal(dy, want_dy)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_stem_kernels_unaligned_and_tail_shapes(cuda_device, dtype):
    """The forwards' scalar load and store paths: widths whose rows are not
    16-byte aligned, a pooled width that is not a multiple of 4, a base
    pointer off the 16-byte grid (a view one element in), a strip cut
    short; codes and values equal to plain."""
    for shape in [(2, 5, 37, 27), (1, 4, 448, 704), (1, 3, 30, 578),
                  (2, 2, 17, 33)]:
        y, scale, shift = _stem_case(shape, dtype, cuda_device, seed=6)
        flat = torch.empty(y.numel() + 1, dtype=dtype, device=cuda_device)
        for t in (y, flat[1:].view(shape).copy_(y)):
            out, idx = kstem.bn_relu_pool_idx(t, scale, shift)
            got = kstem.bn_relu_pool(t, scale, shift)
            torch.cuda.synchronize()
            want, want_idx = kstem.bn_relu_pool_idx_plain(t, scale, shift)
            assert torch.equal(got, want) and torch.equal(out, want)
            assert torch.equal(idx, want_idx)


@pytest.mark.cuda
def test_conv1_trains_through_the_stem_kernel(cuda_device):
    """The hazard of a kernel outside autograd: conv1's weight gradient
    through the kernels is non-zero and equals the plain version's (fp32,
    TF32 off, deterministic cuDNN)."""
    from odtk_tpu_torch.backbones.resnet import ResNet
    net = ResNet(layers=(1, 1, 1, 1), bottleneck=False).to(cuda_device)
    x = torch.randn(2, 3, 128, 160,
                    generator=torch.Generator().manual_seed(4)).to(cuda_device)
    scale, shift = net.bn1.fold()
    grads = []
    flags = torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                       allow_tf32=False)
    with flags:
        for pool in (kstem.bn_relu_pool_train, kstem.bn_relu_pool_plain):
            out = pool(net.conv1(x), scale, shift)
            grads.append(torch.autograd.grad(out.square().sum(),
                                             net.conv1.weight)[0])
    assert grads[0].abs().sum() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=0)


# ------------------------------------------------- fused detection loss
def loss_case(b=2, h=13, w=21, anchors=9, classes=80, dtype=torch.float32,
              device='cpu', seed=0, dim=4):
    """NHWC head views of NCHW tensors, and index-form targets with
    ignore (-1), background (0) and foreground (c+1) anchors."""
    rng = np.random.RandomState(seed)
    n = h * w * anchors
    x = torch.from_numpy(rng.randn(b, anchors * classes, h, w).astype(
        np.float32) * 3).to(device, dtype)
    bx = torch.from_numpy(rng.randn(b, anchors * dim, h, w).astype(
        np.float32) * 0.3).to(device, dtype)
    cls = rng.randint(0, classes, (b, n))
    depth = rng.choice([-1.0, 0.0, 0.0, 0.0], (b, n))
    fg = rng.rand(b, n) < 0.05
    depth[fg] = cls[fg] + 1
    cls = torch.from_numpy(cls).to(device, torch.int32)
    depth = torch.from_numpy(depth.astype(np.float32)).to(device)
    box_t = torch.from_numpy(rng.randn(b, n, dim).astype(
        np.float32) * 0.3).to(device)
    return (x.permute(0, 2, 3, 1), bx.permute(0, 2, 3, 1), cls, box_t,
            depth)


def test_loss_plain_gradients_vanish_off_the_masks():
    """Ignored anchors (depth -1) give no focal gradient, non-foreground
    anchors no box gradient; the sums are finite and positive."""
    x, bx, cls, box_t, depth = loss_case()
    x = x.clone().requires_grad_(True)
    bx = bx.clone().requires_grad_(True)
    c_sum, b_sum = kloss.detection_loss_sums(x, bx, cls, box_t, depth, 80)
    assert c_sum > 0 and b_sum > 0
    dx, dbx = torch.autograd.grad(c_sum + b_sum, (x, bx))
    b = x.shape[0]
    assert (dx.reshape(b, -1, 80)[depth < 0] == 0).all()
    assert (dbx.reshape(b, -1, 4)[depth <= 0] == 0).all()
    assert (dbx.reshape(b, -1, 4)[depth > 0] != 0).any()


def test_loss_wrapper_rejects_bad_input():
    x, bx, cls, box_t, depth = loss_case(device='meta')
    with pytest.raises(ValueError):
        kloss.detection_loss_sums(x, bx, cls, box_t, depth, 80)
    with pytest.raises(ValueError):   # a contiguous NHWC head
        kloss.kernel_operands([x.contiguous()], [bx], [cls], [box_t],
                              [depth], 80)
    with pytest.raises(ValueError):   # more levels than the table holds
        n = kloss.MAX_LEVELS + 1
        kloss.kernel_operands([x] * n, [bx] * n, [cls] * n, [box_t] * n,
                              [depth] * n, 80)


# gradients elementwise against autograd of the dense form in float64: the
# kernels' fast exponential and reciprocal keep fp32 within a relative
# 1e-5; bf16 rounds once from fp32, so within one bf16 ulp (rtol 2^-7) of
# the reference rounded to bf16; both plus 1e-12, far below the
# background logits' gradients
LOSS_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-12),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-12)}


def _loss_levels_vs_plain(cases, g):
    """The kernels through ``detection_loss_sums_levels`` and autograd
    with the cotangent g [L, 2], against the plain version a level at a
    time: sums within a relative 1e-5 of its fp32 sums, gradients within
    LOSS_TOL of its autograd in float64, in the heads' dtype and layout.
    At a logit of exactly 0 autograd of the plain form takes the
    subgradients of its clamp and abs, where the kernel has the
    derivative: those dx elements are left out."""
    leaves = [(x.detach().requires_grad_(True),
               bx.detach().requires_grad_(True)) for x, bx, *_ in cases]
    flat = [t for pair in leaves for t in pair]
    sums = kloss.detection_loss_sums_levels(
        [x for x, _ in leaves], [bx for _, bx in leaves],
        *([c[i] for c in cases] for i in (2, 3, 4)), 80)
    got = torch.autograd.grad((sums * g).sum(), flat)
    torch.cuda.synchronize()
    for i, (x, bx, cls, box_t, depth) in enumerate(cases):
        c_sum, b_sum = kloss.detection_loss_sums_plain(x, bx, cls, box_t,
                                                       depth, 80)
        torch.testing.assert_close(sums[i, 0], c_sum, rtol=1e-5, atol=0)
        torch.testing.assert_close(sums[i, 1], b_sum, rtol=1e-5, atol=1e-6)
        x64 = x.detach().double().requires_grad_(True)
        bx64 = bx.detach().double().requires_grad_(True)
        c64, b64 = kloss.detection_loss_sums_plain(x64, bx64, cls, box_t,
                                                   depth, 80)
        g64 = g[i].double()
        want = torch.autograd.grad(g64[0] * c64 + g64[1] * b64, (x64, bx64))
        for mine, ref, head, keep in zip(got[2 * i:2 * i + 2], want,
                                         (x, bx), (x != 0, None)):
            assert mine.dtype == head.dtype
            assert mine.stride() == head.stride()
            if head.dtype == torch.bfloat16:
                ref = ref.bfloat16()
            mine, ref = mine.double(), ref.double()
            if keep is not None:
                mine, ref = mine[keep], ref[keep]
            torch.testing.assert_close(mine, ref, **LOSS_TOL[x.dtype])
    return sums


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hw', [(13, 21), (100, 144), (1, 1)])
def test_loss_kernel_equals_plain(cuda_device, dtype, hw):
    """One level, HW % 8 != 0 (the scalar path) and == 0 (16-byte
    vectors); the sums the same from run to run (no atomics)."""
    case = loss_case(h=hw[0], w=hw[1], dtype=dtype, device=cuda_device)
    g = torch.tensor([[0.37, 1.9]], device=cuda_device)
    sums = _loss_levels_vs_plain([case], g)
    again = kloss.detection_loss_sums_levels(*([t] for t in case), 80)
    assert torch.equal(again, sums)


@pytest.mark.cuda
def test_loss_autograd_runs_both_kernels(cuda_device):
    """A step's loss launches the forward kernel once and the backward
    kernel once for all its levels; the gradient autograd hands back is
    the backward kernel's for the cotangents of the sums."""
    cases = [loss_case(h=h, w=w, dtype=torch.bfloat16, device=cuda_device,
                       seed=i) for i, (h, w) in enumerate([(16, 24),
                                                           (8, 12), (3, 5)])]
    leaves = [(x.detach().requires_grad_(True),
               bx.detach().requires_grad_(True)) for x, bx, *_ in cases]
    fwd = kloss.detection_loss_fwd_kernel.launches
    bwd = kloss.detection_loss_bwd_kernel.launches
    sums = kloss.detection_loss_sums_levels(
        [x for x, _ in leaves], [bx for _, bx in leaves],
        *([c[i] for c in cases] for i in (2, 3, 4)), 80)
    got = torch.autograd.grad(sums[:, 0].sum() / 7 + sums[:, 1].sum() * 3,
                              [t for pair in leaves for t in pair])
    torch.cuda.synchronize()
    assert kloss.detection_loss_fwd_kernel.launches == fwd + 1
    assert kloss.detection_loss_bwd_kernel.launches == bwd + 1
    ops, geo = kloss.kernel_operands(*zip(*cases), 80)
    g = torch.tensor([[1 / 7, 3.0]] * len(cases), device=cuda_device)
    want = kloss.detection_loss_bwd_kernel(ops, geo, g, 80)
    for i, (dx, dbx) in enumerate(want):
        assert torch.equal(got[2 * i], dx.permute(0, 2, 3, 1))
        assert torch.equal(got[2 * i + 1], dbx.permute(0, 2, 3, 1))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_loss_kernel_equals_plain_at_box_dim_6(cuda_device, dtype):
    """The rotated shape: D = 6 box channels (deltas, sin, cos), A = 27
    anchors, 80 classes; the tolerances of the D = 4 test."""
    case = loss_case(h=25, w=34, anchors=27, dim=6, dtype=dtype,
                     device=cuda_device)
    _loss_levels_vs_plain([case], torch.tensor([[1.0, 1.0]],
                                               device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('anchors,dim', [(9, 4), (27, 6)])
def test_loss_levels_kernel_equals_plain(cuda_device, dtype, anchors, dim):
    """Five levels of a 256 x 320 canvas in one launch each way: P3-P5
    on 16-byte vectors, P6 (20 positions) and P7 (6) scalar; each level's
    sums and gradients against its plain version, under one cotangent
    per sum."""
    cases = [loss_case(h=h, w=w, anchors=anchors, dim=dim, dtype=dtype,
                       device=cuda_device, seed=i)
             for i, (h, w) in enumerate([(32, 40), (16, 20), (8, 10),
                                         (4, 5), (2, 3)])]
    g = torch.from_numpy(np.random.RandomState(1).uniform(
        0.1, 2.0, (5, 2)).astype(np.float32)).to(cuda_device)
    _loss_levels_vs_plain(cases, g)


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [4, 6])
def test_loss_levels_past_one_launch(cuda_device, dim):
    """Ten levels (two FPN backbones), axis (D = 4) and rotated (D = 6):
    a forward and a backward launch for each group of ``level_groups``,
    each level's sums and gradients against its plain version, and
    bit-equal to the launches of its group alone."""
    sizes = [(32, 40), (16, 20), (8, 10), (4, 5), (2, 3)] * 2
    cases = [loss_case(h=h, w=w, dim=dim, dtype=torch.bfloat16,
                       device=cuda_device, seed=i)
             for i, (h, w) in enumerate(sizes)]
    g = torch.from_numpy(np.random.RandomState(2).uniform(
        0.1, 2.0, (10, 2)).astype(np.float32)).to(cuda_device)
    fwd = kloss.detection_loss_fwd_kernel.launches
    bwd = kloss.detection_loss_bwd_kernel.launches
    sums = _loss_levels_vs_plain(cases, g)
    cuts = _build.level_groups(10, kloss.MAX_LEVELS)
    assert len(cuts) == 2
    assert kloss.detection_loss_fwd_kernel.launches == fwd + len(cuts)
    assert kloss.detection_loss_bwd_kernel.launches == bwd + len(cuts)
    for cut in cuts:
        ops, geo = kloss.kernel_operands(*zip(*cases[cut]), 80)
        assert torch.equal(sums[cut],
                           kloss.detection_loss_fwd_kernel(ops, geo, 80))


@pytest.mark.cuda
def test_loss_kernel_misaligned_heads_take_the_scalar_path(cuda_device):
    """Heads whose storage starts off a 16-byte boundary (HW % 8 == 0)
    are read and written by the scalar steps, with the same results."""
    x, bx, cls, box_t, depth = loss_case(h=8, w=16, dtype=torch.bfloat16,
                                         device=cuda_device)
    nchw = x.permute(0, 3, 1, 2)
    buf = torch.empty(nchw.numel() + 1, dtype=nchw.dtype, device=cuda_device)
    shifted = buf[1:].view(nchw.shape).copy_(nchw)
    assert shifted.data_ptr() % 16 != 0
    ops, geo = kloss.kernel_operands([shifted.permute(0, 2, 3, 1)], [bx],
                                     [cls], [box_t], [depth], 80)
    assert kloss._table(ops, geo)[0][8] == 0      # the level's vec flag
    case = (shifted.permute(0, 2, 3, 1), bx, cls, box_t, depth)
    _loss_levels_vs_plain([case], torch.tensor([[1.0, 0.5]],
                                               device=cuda_device))


# -------------------------------------------------- rotated NMS, matcher
def rotated_nms_case(kind, b=2, n=2000, seed=0):
    """(x1, y1, x2, y2, sin, cos) boxes in clusters; 'ties' puts scores
    on a 1/8 grid, 'coincident' repeats boxes and shares corners."""
    rng = np.random.RandomState(seed)
    ctr = rng.randint(40, 600, (b, 60, 2))
    ctr = np.take_along_axis(ctr, rng.randint(0, 60, (b, n))[..., None], 1)
    ctr = ctr + rng.uniform(-10, 10, (b, n, 2))
    wh = rng.uniform(8, 80, (b, n, 2))
    th = rng.uniform(-np.pi / 2, np.pi / 2, (b, n))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2, np.sin(th)[..., None],
                            np.cos(th)[..., None]], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    scores[rng.rand(b, n) < 0.3] = 0.0
    classes = rng.randint(0, 4, (b, n)).astype(np.float32)
    if kind == 'ties':
        scores = (np.ceil(scores * 8) / 8).astype(np.float32)
    elif kind == 'coincident':
        boxes[:, 1::7] = boxes[:, 0:-1:7][:, :boxes[:, 1::7].shape[1]]
        boxes[:, 2::7, :2] = boxes[:, 0:-2:7, :2][:, :boxes[:, 2::7].shape[1]]
    elif kind == 'zeros':
        scores[:] = 0.0
    elif kind == 'one_class':
        classes[:] = 3.0
    elif kind == 'nonfinite':
        # NaN and infinite corners: the clip's NaN rule decides, no skip
        boxes[:, 0, 0] = np.nan
        boxes[:, 1, 2] = np.inf
        boxes[:, 2, 4:] = np.nan
        scores[:, :3] = [1.0, 0.99, 0.98]
        classes[:, :4] = 1.0
    elif kind == 'nan_scores':
        scores[0, 17] = np.nan      # image 0 records nothing
        scores[1, 3] = -np.inf      # a dead candidate, not a NaN
    return scores, boxes, classes


@pytest.mark.cuda
@pytest.mark.parametrize('kind,n', [('random', 2000), ('ties', 5000),
                                    ('coincident', 3001), ('zeros', 100),
                                    ('large', 16384), ('one_class', 1000),
                                    ('nonfinite', 300), ('random', 63),
                                    ('random', 1), ('nan_scores', 2000)])
def test_nms_rotated_kernel_equals_plain(cuda_device, kind, n):
    """Every selected score, box and class equal: the kernel's clip is
    the plain version's arithmetic, rounded alike."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rotated_nms_case(kind, n=n)]
    before = knms_rot.nms_rotated.launches
    got = knms_rot.nms_rotated(*args, 0.5, 100)
    torch.cuda.synchronize()
    assert knms_rot.nms_rotated.launches == before + 1
    want = knms_rot.nms_rotated_plain(*args, 0.5, 100)
    for g, w in zip(got, want):     # equal, a NaN box copied as NaN
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize('thr,ndet', [(0.0, 100), (-1.0, 50), (0.3, 1000),
                                      (0.9, 7)])
def test_nms_rotated_kernel_thresholds_and_depths(cuda_device, thr, ndet):
    """The AABB skip only where the threshold is >= 0 (a skipped pair
    reads as IoU 0); D past the live count, and D of a few."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rotated_nms_case('coincident', n=1500)]
    got = knms_rot.nms_rotated(*args, thr, ndet)
    torch.cuda.synchronize()
    want = knms_rot.nms_rotated_plain(*args, thr, ndet)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def match_case(b=3, m=24, stride=8, size=(320, 256), seed=0,
               device='cpu'):
    """Anchor quads of one level, and rotated targets with padding rows,
    one empty image and targets out of the size band."""
    rng = np.random.RandomState(seed)
    table = generate_anchors_rotated(stride, [1.0, 2.0, 0.5],
                                     [4 * 2 ** (i / 3) for i in range(3)],
                                     [-np.pi / 6, 0, np.pi / 6])
    anchors = level_anchors(size[0] // stride, size[1] // stride, stride,
                            table[1], device)
    t = np.full((b, m, 6), -1.0, np.float32)
    for i, k in enumerate([m - 4, 0, m][:b]):
        t[i, :k, :2] = rng.uniform(0, size[0] - 60, (k, 2))
        t[i, :k, 2:4] = rng.uniform(10, 90, (k, 2))
        t[i, :k, 4] = rng.uniform(-np.pi / 4, np.pi / 4, k)
        t[i, :k, 5] = rng.randint(0, 80, k)
    t[-1, -1, 2:4] = [900, 900]
    return anchors, torch.from_numpy(t).to(device), table


@pytest.mark.cuda
def test_match_rotated_kernel_holds_the_plain_contract(cuda_device):
    """Where the plain stream's best IoU is > 0, the kernel's IoU and
    slot are equal to it; elsewhere both are <= 0."""
    anchors, t, _ = match_case(device=cuda_device)
    _, quads = rotate_boxes(t[..., :5])
    active = t[..., 5] > -1
    areas = quad_areas(quads)
    amin, amax = quad_areas(anchors).aminmax()
    active &= (areas >= 0.4 * amin) & (areas * 0.4 <= amax)
    rows, n_act = pack_active(quads, active)
    got_iou, got_slot = kmatch.rotated_match(anchors, rows, n_act)
    torch.cuda.synchronize()
    want_iou, want_slot = kmatch.rotated_match_plain(anchors, rows, n_act)
    hit = want_iou > 0
    assert hit.sum() > 1000 and (~hit).sum() > 1000
    assert torch.equal(got_iou[hit], want_iou[hit])
    assert torch.equal(got_slot[hit], want_slot[hit])
    assert (got_iou[~hit] <= 0).all()
    assert (got_iou[1] == -2).all() and (got_slot[1] == 0).all()
    assert (got_iou == -2).sum() > (want_iou == -2).sum()   # the AABB skip


@pytest.mark.cuda
def test_rotated_assignment_through_the_kernel_equals_plain(cuda_device,
                                                           monkeypatch):
    """The assignment on the card through the matcher kernel against the
    same assignment through the plain matcher: depth equal everywhere;
    cls and deltas equal on the foreground."""
    _, t, table = match_case(device=cuda_device)
    before = kmatch.rotated_match_levels.launches
    cls, deltas, depth = snap_to_anchors_rotated_batched(t, (320, 256), 8,
                                                         table, 80)
    torch.cuda.synchronize()
    assert kmatch.rotated_match_levels.launches == before + 1
    monkeypatch.setattr(kmatch, 'rotated_match', kmatch.rotated_match_plain)
    w_cls, w_deltas, w_depth = snap_to_anchors_rotated_batched(
        t, (320, 256), 8, table, 80)
    assert torch.equal(depth, w_depth)
    fg = w_depth > 0
    assert fg.sum() > 50
    assert torch.equal(cls[fg], w_cls[fg])
    assert torch.equal(deltas[fg], w_deltas[fg])


@pytest.mark.cuda
def test_match_levels_kernel_holds_the_plain_contract(cuda_device,
                                                      monkeypatch):
    """Five ragged levels (no level a multiple of 256 anchors) in one
    launch, an image without active targets, a target touching the anchor
    box that ends P3's first tile: each level under the contract, and the
    levels assignment's depth equal to the plain matcher's everywhere."""
    from odtk_tpu_torch.ops.assign import rotated_targets
    from odtk_tpu_torch.ops.iou_rotated import match_inputs_levels

    size, strides = (336, 272), [8, 16, 32, 64, 128]
    sizes = [(size[0] // s * s, size[1] // s * s) for s in strides]
    tables = [generate_anchors_rotated(s, [1.0, 2.0, 0.5],
                                       [4 * 2 ** (i / 3) for i in range(3)],
                                       [-np.pi / 6, 0, np.pi / 6])
              for s in strides]
    anchors = [level_anchors(w // s, h // s, s, tb[1], cuda_device)
               for (w, h), s, tb in zip(sizes, strides, tables)]
    assert all(a.shape[0] % 256 for a in anchors)
    _, t, _ = match_case(device=cuda_device)
    edge = anchors[0].reshape(-1, 4, 2)[255, :, 0].max()
    t[2, 0, :5] = torch.stack([edge, *t.new_tensor([20.0, 30.0, 25.0, 0.0])])
    _, valid, _, quads = rotated_targets(t)
    subj, rows, n_act = match_inputs_levels(anchors, quads, valid, 0.4)
    assert (n_act[:, 1] == 0).all() and n_act[0, 2] > 0
    before = kmatch.rotated_match_levels.launches
    got = kmatch.rotated_match_levels(subj, rows, n_act)
    torch.cuda.synchronize()
    assert kmatch.rotated_match_levels.launches == before + 1
    want = kmatch.rotated_match_levels_plain(subj, rows, n_act)
    for (g_iou, g_slot), (w_iou, w_slot) in zip(got, want):
        hit = w_iou > 0
        assert torch.equal(g_iou[hit], w_iou[hit])
        assert torch.equal(g_slot[hit], w_slot[hit])
        assert (g_iou[~hit] <= 0).all() and (g_iou[1] == -2).all()
    assert (want[0][0] > 0).sum() > 1000

    got = snap_to_anchors_rotated_levels(t, sizes, strides, tables, 80)
    torch.cuda.synchronize()
    assert kmatch.rotated_match_levels.launches == before + 2
    monkeypatch.setattr(kmatch, 'rotated_match_levels',
                        kmatch.rotated_match_levels_plain)
    want = snap_to_anchors_rotated_levels(t, sizes, strides, tables, 80)
    for cls, deltas, depth, w_cls, w_deltas, w_depth in zip(*got, *want):
        assert torch.equal(depth, w_depth)
        fg = w_depth > 0
        assert torch.equal(cls[fg], w_cls[fg])
        assert torch.equal(deltas[fg], w_deltas[fg])


@pytest.mark.cuda
def test_match_levels_past_one_launch(cuda_device):
    """Five levels given twice (10, two FPN backbones): a launch for each
    group of ``level_groups``, each level bit-equal to its launch alone
    and under the plain contract."""
    from odtk_tpu_torch.ops.assign import rotated_targets
    from odtk_tpu_torch.ops.iou_rotated import match_inputs_levels

    size, strides = (336, 272), [8, 16, 32, 64, 128] * 2
    anchors = [level_anchors(size[0] // s, size[1] // s, s,
                             generate_anchors_rotated(
                                 s, [1.0, 2.0, 0.5],
                                 [4 * 2 ** (i / 3) for i in range(3)],
                                 [-np.pi / 6, 0, np.pi / 6])[1], cuda_device)
               for s in strides]
    _, t, _ = match_case(device=cuda_device)
    _, valid, _, quads = rotated_targets(t)
    subj, rows, n_act = match_inputs_levels(anchors, quads, valid, 0.4)
    before = kmatch.rotated_match_levels.launches
    got = kmatch.rotated_match_levels(subj, rows, n_act)
    torch.cuda.synchronize()
    assert len(got) == 10
    assert (kmatch.rotated_match_levels.launches
            == before + len(_build.level_groups(10, kmatch.MAX_LEVELS)))
    want = kmatch.rotated_match_levels_plain(subj, rows, n_act)
    for level, ((g_iou, g_slot), (w_iou, w_slot)) in enumerate(
            zip(got, want)):
        one = kmatch.rotated_match_levels(
            subj[level:level + 1], rows[level:level + 1],
            n_act[level:level + 1])[0]
        assert torch.equal(g_iou, one[0]) and torch.equal(g_slot, one[1])
        hit = w_iou > 0
        assert torch.equal(g_iou[hit], w_iou[hit])
        assert torch.equal(g_slot[hit], w_slot[hit])
        assert (g_iou[~hit] <= 0).all()
    assert (want[5][0] > 0).sum() > 1000


@pytest.mark.cuda
def test_rotated_best_match_kernel_equals_plain(cuda_device):
    """The unbatched variant: every target visited, invalid ones -1, no
    skip; IoU and index equal everywhere."""
    anchors, t, _ = match_case(device=cuda_device)
    _, quads = rotate_boxes(t[0, :, :5])
    valid = t[0, :, 5] > -1
    got = kmatch.rotated_best_match(anchors, quads, valid)
    torch.cuda.synchronize()
    want = kmatch.rotated_best_match_plain(anchors, quads, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0] > 0.5).any()


def _bits_equal(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize('m, invalid', [(33, True), (200, True),
                                        (33, False)])
def test_rotated_best_match_kernel_degenerate_equals_plain(cuda_device, m,
                                                           invalid):
    """Row 8 on degenerate inputs (``rotated_cases.degenerate_case``:
    zero-area, NaN, infinite and huge quads, touching boxes, ties, invalid
    rows before and between the valid ones, 2920 anchors): IoU bit for
    bit and index equal to the plain fold, one launch."""
    anchors, clips, valid = (t.to(cuda_device) for t in
                             degenerate_case(m, invalid=invalid))
    before = kmatch.rotated_best_match.launches
    got = kmatch.rotated_best_match(anchors, clips, valid)
    torch.cuda.synchronize()
    assert kmatch.rotated_best_match.launches == before + 1
    _bits_equal(got, kmatch.rotated_best_match_plain(anchors, clips, valid))
    assert (got[0] > 0.5).any() and (got[0] == 0).any()


@pytest.mark.cuda
def test_rotated_best_match_kernel_takes_any_row_count(cuda_device):
    """Row 8 against 7000 target rows (the former kernel staged every row
    in shared memory and refused more than 6400), a third invalid: equal
    to the plain fold bit for bit."""
    rng = np.random.RandomState(3)
    anchors, _, _ = degenerate_case(33)
    t = np.zeros((7000, 5), np.float32)
    t[:, :2] = rng.uniform(-10, 90, (7000, 2))
    t[:, 2:4] = rng.uniform(4, 50, (7000, 2))
    t[:, 4] = rng.uniform(-np.pi / 4, np.pi / 4, 7000)
    _, clips = rotate_boxes(torch.from_numpy(t))
    valid = torch.from_numpy(rng.rand(7000) > 1 / 3)
    args = [a.to(cuda_device) for a in (anchors[:-4], clips, valid)]
    got = kmatch.rotated_best_match(*args)
    torch.cuda.synchronize()
    _bits_equal(got, kmatch.rotated_best_match_plain(*args))


def test_rotated_kernel_wrappers_reject_bad_input():
    meta = torch.zeros(1, 10, device='meta')
    with pytest.raises(ValueError):
        knms_rot.nms_rotated(meta, torch.zeros(1, 10, 6, device='meta'), meta)
    with pytest.raises(ValueError):
        kmatch.rotated_match(torch.zeros(10, 8, device='meta'),
                             torch.zeros(1, 3, 9, device='meta'),
                             torch.zeros(1, device='meta'))
    with pytest.raises(ValueError):
        kmatch.rotated_best_match(torch.zeros(10, 8, device='meta'),
                                  torch.zeros(3, 8, device='meta'),
                                  torch.zeros(3, device='meta'))


def test_rotated_nms_plain_semantics():
    """Zero-padded and score-descending; a box identical to a kept one of
    its class is suppressed, one of another class is not."""
    s, b, c = (torch.from_numpy(a) for a in rotated_nms_case('random',
                                                              n=200))
    b[:, 1] = b[:, 0]
    s[:, :3] = torch.tensor([0.999, 0.998, 0.997])
    b[:, 2] = b[:, 0]
    c[:, 1] = c[:, 0]
    c[:, 2] = c[:, 0] + 1
    out_s, out_b, out_c = knms_rot.nms_rotated_plain(s, b, c, 0.5, 150)
    assert (out_s[:, :-1] >= out_s[:, 1:]).all()
    kept = out_s > 0
    assert (out_s[~kept] == 0).all() and (out_b[~kept] == 0).all()
    for i in range(2):
        assert (out_s[i] == 0.999).any() and (out_s[i] == 0.997).any()
        assert not (out_s[i] == 0.998).any()
    corners = sincos_box_corners(out_b)
    assert torch.isfinite(corners).all()


# ------------------------------------------------------------ focal sum
def _focal_case(device, dtype, hw, b=2, a=9, k=80, seed=0):
    """An NHWC view of an NCHW head (the layout the convolutions leave),
    class indices, and depths with ignored, background and foreground
    anchors."""
    h, w = hw
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, a * k, h, w, generator=g) * 2).to(device, dtype)
    n = h * w * a
    cls_idx = torch.randint(0, k, (b, n), generator=g).float().to(device)
    depth = torch.randint(-1, 3, (b, n), generator=g).float().to(device)
    return x.permute(0, 2, 3, 1), cls_idx, depth, k


def _hold_focal_to_plain(x, cls_idx, depth, k, got, dx, g):
    """Row 6's checks: the forward sum within a relative 1e-6 of the
    plain one; dx = d(g sum)/dx elementwise against the plain version's
    autograd in float64: within one bf16 ulp of it rounded to bf16 (bf16),
    or a relative 1e-5 (fp32), plus 1e-10, far below the smallest values
    that matter (the fp32 closed form, as the TPU kernel's, computes
    q = 1 - p_t and so loses relative precision only where q and
    |dx| ~ q^3 are tiny); dx in the head's dtype and strides."""
    xf = x.detach().float().requires_grad_(True)
    want = kfocal.focal_sum_plain(xf, cls_idx, depth, k)
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
    assert dx.dtype == x.dtype and dx.stride() == x.stride()
    x64 = x.detach().double().requires_grad_(True)
    ref, = torch.autograd.grad(kfocal.focal_sum_plain(x64, cls_idx, depth, k),
                               x64, g.double())
    # at a logit of exactly 0, autograd of the plain form takes the
    # subgradients of its clamp and abs; the kernel has the derivative
    nz = x != 0
    if x.dtype == torch.bfloat16:
        torch.testing.assert_close(dx.double()[nz],
                                   ref.bfloat16().double()[nz],
                                   rtol=2 ** -7, atol=1e-10)
    else:
        torch.testing.assert_close(dx.double()[nz], ref[nz], rtol=1e-5,
                                   atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hw', [(13, 21), (100, 144), (1, 1)])
def test_focal_kernels_equal_plain(cuda_device, dtype, hw):
    """Row 6 on the NHWC view of an NCHW head, the vector path where HW
    is a multiple of 8 (100 x 144), the scalar one elsewhere: within the
    plain version's tolerances (``_hold_focal_to_plain``)."""
    x, cls_idx, depth, k = _focal_case(cuda_device, dtype, hw)
    g = torch.tensor(0.37, device=cuda_device)
    got = kfocal.focal_sum_kernel(x, cls_idx, depth, k)
    dx = kfocal.focal_sum_dx_kernel(x, cls_idx, depth, g, k)
    torch.cuda.synchronize()
    _hold_focal_to_plain(x, cls_idx, depth, k, got, dx, g)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['nchw_view', 'nhwc'])
@pytest.mark.parametrize('hw', [(14, 18), (7, 9)])
def test_focal_kernels_scalar_paths_repeat(cuda_device, dtype, layout, hw):
    """Row 6 where HW is not a multiple of 8 (P6's 252 and P7's 63
    positions at the train canvas), on the NHWC view of an NCHW head and
    on a contiguous NHWC head (both the scalar path, the classes cut into
    slices): within the plain version's tolerances, and the same bits on
    a second run (the sum's fixed order)."""
    x, cls_idx, depth, k = _focal_case(cuda_device, dtype, hw)
    if layout == 'nhwc':
        x = x.contiguous()
    g = torch.tensor(0.37, device=cuda_device)
    runs = [(kfocal.focal_sum_kernel(x, cls_idx, depth, k),
             kfocal.focal_sum_dx_kernel(x, cls_idx, depth, g, k))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    _hold_focal_to_plain(x, cls_idx, depth, k, *runs[0], g)


def test_focal_kernel_blocks_cut_small_levels_into_class_slices():
    """The forward kernel's grid (``kernel_blocks``, the mirror of
    csrc/focal_sum.cu's make_level): at the train shape (b=8, A=9, K=80)
    P3 takes all 80 classes a thread, the smaller levels cut them into
    slices until a launch has ~2^17 threads; a thread always has 8
    positions of one (image, anchor)."""
    want = {16128: 1134, 4032: 1134, 1008: 993, 252: 720, 63: 360}
    for hw, blocks in want.items():
        assert kfocal.kernel_blocks(8, 9, 80, hw) == blocks
    assert kfocal.kernel_blocks(2, 9, 80, 0) == 0


@pytest.mark.cuda
def test_focal_dx_kernel_at_zero_logits(cuda_device):
    """At x == 0: s = p_t = q = 1/2, ce = log 2, so d loss/dx =
    -a_t (2t - 1) / 4 (log 2 + 1/2), the derivative, for t = 0 and 1."""
    x = torch.zeros(1, 1, 1, 4, device=cuda_device)       # A = 1, K = 4
    cls_idx = torch.tensor([[2.0]], device=cuda_device)
    depth = torch.tensor([[1.0]], device=cuda_device)
    dx = kfocal.focal_sum_dx_kernel(x, cls_idx, depth,
                                    torch.tensor(1.0, device=cuda_device), 4)
    unit = (np.log(2.0) + 0.5) / 4
    want = torch.tensor([0.75 * unit, 0.75 * unit, -0.25 * unit,
                         0.75 * unit], dtype=torch.float32,
                        device=cuda_device)
    torch.testing.assert_close(dx.flatten(), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_focal_autograd_runs_both_kernels(cuda_device):
    x, cls_idx, depth, k = _focal_case(cuda_device, torch.bfloat16, (9, 7))
    fwd, bwd = (kfocal.focal_sum_kernel.launches,
                kfocal.focal_sum_dx_kernel.launches)
    xr = x.detach().clone().requires_grad_(True)
    (kfocal.focal_sum(xr, cls_idx, depth, k) * 0.5).backward()
    torch.cuda.synchronize()
    assert kfocal.focal_sum_kernel.launches == fwd + 1
    assert kfocal.focal_sum_dx_kernel.launches == bwd + 1
    want = kfocal.focal_sum_dx_kernel(x, cls_idx, depth,
                                      torch.tensor(0.5, device=cuda_device),
                                      k)
    assert torch.equal(xr.grad, want)


# ------------------------------------------------- engines on the card
@pytest.mark.cuda
@pytest.mark.parametrize('rotated', [False, True])
def test_engine_on_the_card_runs_the_kernels(cuda_device, rotated):
    """An fp32 engine exported on the card launches the stem kernel and
    NMS (rotated NMS) once per call, and equals the checkpoint path."""
    from odtk_tpu_torch.export import export_model
    from odtk_tpu_torch.model import Model

    model = Model('ResNet18FPN', classes=3, rotated_bbox=rotated,
                  config={'threshold': 0.001}).initialize(0).to(cuda_device)
    engine = export_model(model, (256, 256), precision='fp32',
                          dynamic_batch_opts=[2])
    nms_fn = knms_rot.nms_rotated if rotated else knms.nms
    counts = (nms_fn.launches, kstem.bn_relu_pool.launches)
    x = torch.randn(2, 256, 256, 3,
                    generator=torch.Generator().manual_seed(0))
    got = engine(x.to(cuda_device))
    torch.cuda.synchronize()
    assert (nms_fn.launches, kstem.bn_relu_pool.launches) == (
        counts[0] + 1, counts[1] + 1)
    want = model.inference_fn(x.to(cuda_device))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cpp_runtime_runs_the_kernels(cuda_device, tmp_path):
    """``odtk_ops.cpp`` built with the kernel library, and ``odtk_infer``
    on a small bf16 ``.cppengine`` (ResNet18FPN, 3 classes, 256 px, u8
    contract) in a process without Python: its detections equal the
    Python-loaded package's on the same bytes, bit for bit, and its
    counters show one NMS and one stem launch an inference."""
    import subprocess

    from odtk_tpu_torch.export import export_cpp_engine, load_cpp_engine
    from odtk_tpu_torch.extras.cppapi import build as cppapi_build
    from odtk_tpu_torch.model import Model

    binaries = cppapi_build.build()
    model = Model('ResNet18FPN', classes=3,
                  config={'threshold': 0.001}).initialize(0).to(cuda_device)
    path = str(tmp_path / 'm.cppengine')
    export_cpp_engine(model, (256, 256), batch=2, path=path,
                      precision='bf16', input_format='u8')
    pixels = np.random.RandomState(0).randint(0, 256, (256, 256, 3)).astype(
        np.uint8)
    (tmp_path / 'im.ppm').write_bytes(b'P6\n256 256\n255\n'
                                      + pixels.tobytes())
    run = subprocess.run(
        [binaries['odtk_infer'], path, str(tmp_path / 'im.ppm'),
         str(tmp_path / 'out.ppm'), str(tmp_path / 'det.txt')],
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert ('launches after 101 inferences: nms=101 nms_rotated=0 '
            'bn_relu_pool=101') in run.stdout
    rows = np.loadtxt(tmp_path / 'det.txt', ndmin=2).astype(np.float32)
    batch = np.zeros((2, 256, 256, 3), np.uint8)
    batch[0] = pixels
    want = [o.cpu().numpy() for o in load_cpp_engine(path)(
        torch.from_numpy(batch).to(cuda_device))]
    got = (rows[:, 2].reshape(2, -1), rows[:, 4:].reshape(2, -1),
           rows[:, 3].reshape(2, -1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert (want[0] > 0).sum() > 0


# ------------------------------------------------- w8a8 convolution

def conv_w8a8_case(b, c, h, w, o, k, stride, groups, bias, in_dtype,
                   device, seed=0):
    """The w8a8 operator's arguments: x N(0, 2) with NaN, +inf and -inf
    planted and values on .5 code boundaries (act_scale 0.25), a random
    int8 weight in the kernel's layout, scales as calibration makes them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g) * 2
    flat = x.view(-1)
    flat[:24] = (torch.randint(-300, 300, (24,), generator=g) + 0.5) * 0.25
    flat[31], flat[37], flat[-1] = float('nan'), float('inf'), -float('inf')
    wq = torch.randint(-127, 128, (o, c // groups, k, k), generator=g,
                       dtype=torch.int8)
    w_scale = torch.rand(o, generator=g) * 0.01 + 1e-3
    bvec = torch.randn(o, generator=g) if bias else None
    return (x.to(device, in_dtype), kconv.pack_weight(wq).to(device),
            w_scale.to(device), torch.tensor(0.25, device=device),
            None if bvec is None else bvec.to(device),
            (stride, stride), (k // 2, k // 2), groups)


# (b, c, h, w, o, kernel, stride, groups, bias): the conv kinds of the
# w8a8 path, the stem's 7x7/s2 over 3 channels (K = 7 x 7 x 4 = 196, not a
# multiple of the 128-byte K tile), a 1x1 with K = 16, odd sizes, batch 1
# and 3, output channels off the 64 / 128 / 256 tiles (36, 72, 720),
# depthwise with and without bias; then the plan's routes at larger
# sizes: P6's K = 18,432 split over 29 slices, 128-pixel tiles that cross
# image boundaries, N = 720 and 36 at P3's M (b=2, 112 x 176), conv1 over
# 3 channels on 4,928 tiles, a grid of more work units than SMs, and the
# packed route (up to 4 input channels, a tap a 4-byte word) of
# MobileNetV2FPN's stem and of a single channel
CONV_CASES = {
    'stem_7x7s2_c3': (2, 3, 37, 51, 64, 7, 2, 1, False),
    '1x1_k16': (3, 16, 9, 13, 24, 1, 1, 1, True),
    '1x1_c256': (1, 256, 15, 21, 64, 1, 1, 1, False),
    '3x3s1_odd': (3, 40, 17, 23, 72, 3, 1, 1, True),
    '3x3s2_p6': (1, 512, 7, 11, 256, 3, 2, 1, True),
    'head_720': (2, 256, 7, 11, 720, 3, 1, 1, True),
    'head_36': (1, 256, 5, 9, 36, 3, 1, 1, True),
    'depthwise': (2, 96, 19, 25, 96, 3, 1, 96, False),
    'depthwise_s2_bias': (3, 144, 15, 13, 144, 3, 2, 144, True),
    'p6_split_k': (1, 2048, 7, 11, 256, 3, 2, 1, True),
    'm_tail_images': (3, 64, 9, 15, 128, 3, 1, 1, True),
    'head_720_p3': (2, 256, 112, 176, 720, 3, 1, 1, True),
    'head_36_p3': (2, 256, 112, 176, 36, 3, 1, 1, True),
    'stem_c3_conv1': (2, 3, 896, 1408, 64, 7, 2, 1, False),
    'more_units_than_sms': (2, 64, 56, 88, 256, 1, 1, 1, False),
    'mobilenet_stem_c3': (2, 3, 96, 144, 32, 3, 2, 1, False),
    'one_channel': (1, 1, 20, 30, 16, 3, 1, 1, True),
}

# what the plan must give the cases that exist for a route
CONV_CASE_PLANS = {
    'p6_split_k': lambda p: p.splits == 29 and p.route == 'gather',
    'm_tail_images': lambda p: p.m % kconv.TILE_M != 0,
    'head_720_p3': lambda p: p.splits == 1 and p.bn == 256,
    'head_36_p3': lambda p: p.splits == 1 and p.bn == 64,
    'stem_c3_conv1': lambda p: p.m_tiles == 4928,
    'more_units_than_sms': lambda p: (p.route == 'dense'
                                      and p.units > kconv.SMS),
    'stem_7x7s2_c3': lambda p: p.route == 'packed' and p.k_tiles == 2,
    'mobilenet_stem_c3': lambda p: p.route == 'packed',
    'one_channel': lambda p: p.route == 'packed',
}


@pytest.mark.cuda
@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize('name', list(CONV_CASES))
def test_conv_w8a8_kernel_bit_equal_plain(cuda_device, name, dtypes):
    """The kernel (quantize pass, then the wgmma implicit GEMM, with the
    finish kernel where K is split, or, grouped, the direct kernel) equal
    to the plain version bit for bit, NaN and +-inf inputs included, fp32
    and bf16 in and out; one launch counted."""
    in_dtype, out_dtype = dtypes
    args = conv_w8a8_case(*CONV_CASES[name], in_dtype, cuda_device)
    if name in CONV_CASE_PLANS:
        b, c, h, w = args[0].shape
        o, kh, kw, _ = args[1].shape
        assert CONV_CASE_PLANS[name](kconv.plan(b, c, h, w, o, kh, kw,
                                                *args[5], *args[6], args[7]))
    before = kconv.conv_w8a8.launches
    got = kconv.conv_w8a8(*args, out_dtype)
    torch.cuda.synchronize()
    assert kconv.conv_w8a8.launches == before + 1
    want = kconv.conv_w8a8_plain(*args, out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_conv_w8a8_launch_error_raises(cuda_device):
    """A launch the card refuses (a quantize pass of more than 65535
    blocks of 64 channels) raises from the wrapper and counts no launch;
    a tensor on another device or not contiguous is refused before."""
    o, c = 16, 65536 * 64 + 1
    x = torch.zeros(1, c, 1, 1, dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros(o, 1, 1, kconv.padded(c), dtype=torch.int8,
                    device=cuda_device)
    args = (w, torch.ones(o, device=cuda_device),
            torch.tensor(0.1, device=cuda_device), None, (1, 1), (0, 0), 1,
            torch.float32)
    before = kconv.conv_w8a8.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        kconv.conv_w8a8(x, *args)
    assert kconv.conv_w8a8.launches == before
    del w, x
    small = conv_w8a8_case(1, 8, 5, 5, 8, 3, 1, 1, False, torch.float32,
                           cuda_device)
    with pytest.raises(ValueError):
        kconv.conv_w8a8(small[0].cpu(), *small[1:], torch.float32)
    with pytest.raises(ValueError):
        kconv.conv_w8a8(small[0].transpose(2, 3), *small[1:], torch.float32)


# ------------------------------------------------------- yuv420 train step
@pytest.mark.cuda
def test_yuv420_train_step_on_the_card(cuda_device):
    """One yuv420 SGD step of ResNet18FPN on the card beside the same
    step on the CPU (fp32, TF32 off, deterministic cuDNN, the same seeded
    init and planes): the stem's argmax forward and backward and the
    loss's forward and backward kernels launch once each; the image the
    planes assemble to equals the CPU's within 1e-6; the losses agree
    at rtol 1e-4; the parameters stay finite and conv1 moves."""
    from odtk_tpu_torch import train as train_mod
    from odtk_tpu_torch.data.loader import fold_yuv_affine
    from odtk_tpu_torch.model import Model
    from odtk_tpu_torch.ops import apply_color_affine_yuv
    from odtk_tpu_torch.ops.color import IMAGENET_MEAN, IMAGENET_STD

    rng = np.random.RandomState(5)
    b, h, w = 2, 128, 160
    y = rng.randint(0, 256, (b, h, w)).astype(np.uint8)
    cbcr = rng.randint(0, 256, (b, h // 2, w // 2, 2)).astype(np.uint8)
    normalize = np.concatenate(
        [np.diag(1.0 / (255.0 * IMAGENET_STD)),
         (-IMAGENET_MEAN / IMAGENET_STD)[:, None]], axis=1)
    colors = fold_yuv_affine(np.repeat(normalize[None], b, 0).astype(
        np.float32) * np.float32(1.01))
    sizes = np.asarray([[128, 160], [100, 120]], np.float32)
    targets = np.full((b, 8, 5), -1, np.float32)
    targets[0, :2] = [[10, 12, 60, 50, 1], [70, 40, 48, 64, 0]]
    targets[1, :1] = [[30, 20, 40, 70, 2]]
    counted = (kstem.bn_relu_pool_idx, kstem.bn_relu_pool_bwd,
               kloss.detection_loss_fwd_kernel,
               kloss.detection_loss_bwd_kernel)
    out = {}
    for device in (torch.device('cpu'), cuda_device):
        model = Model('ResNet18FPN', classes=3).initialize(0)
        model.to(device)
        model.set_dtype(torch.float32)
        opt = train_mod.make_optimizer(model.module.parameters(), 0.01)
        step = train_mod.make_train_step(model, opt, feed='yuv420')
        args = [torch.from_numpy(a).to(device)
                for a in (y, cbcr, targets, colors, sizes)]
        before = [k.launches for k in counted]
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            losses = step(0.01, *args)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        out[device.type] = dict(
            launches=[k.launches - n for k, n in zip(counted, before)],
            losses=[float(t) for t in losses],
            image=apply_color_affine_yuv(args[0], args[1], args[3],
                                         args[4]).cpu(),
            params={k: p.detach().cpu() for k, p in
                    model.module.named_parameters()})
    cpu, card = out['cpu'], out['cuda']
    assert cpu['launches'] == [0, 0, 0, 0]
    assert card['launches'] == [1, 1, 1, 1]
    torch.testing.assert_close(card['image'], cpu['image'], rtol=0,
                               atol=1e-6)
    assert all(np.isfinite(card['losses'])) and card['losses'][0] > 0
    np.testing.assert_allclose(card['losses'], cpu['losses'], rtol=1e-4)
    assert all(torch.isfinite(p).all() for p in card['params'].values())
    init = Model('ResNet18FPN', classes=3).initialize(0).module.state_dict()
    conv1 = 'backbones.ResNet18FPN.features.conv1.weight'
    assert not torch.equal(card['params'][conv1], init[conv1])
