"""The w8a8 convolution's launch plan and index math, on the CPU.

``ops/kernels/conv_w8a8.py:plan`` chooses, from a call's shapes alone,
how ``csrc/conv_w8a8.cu`` runs it: the N tile, the split of K into slices
(an int32 workspace and a finish kernel) and the route of the A operand
(TMA for a 1 x 1 stride-1 call, a cp.async gather otherwise). This file
holds that plan on every conv call of ResNet50FPN and MobileNetV2FPN at
b=2, 896 x 1408 (the shapes from a fake-tensor forward: no convolution
runs), and replays the kernel's arithmetic in plain torch: the quantize
pass's NHWC copy, the A gather (window, zero padding, K order, the K tail
and the rows past M zero-filled as TMA and cp.async fill them), the
weight as TMA reads it, the partial sums of each K slice in int64 and
their int32 sum in slice order, then the rescale. The replay must equal
``conv_w8a8_plain`` bit for bit. The card's kernels are held to the
plain version in ``tests/test_torch_kernels.py`` (``-m cuda``).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops.kernels import conv_w8a8 as kconv

from test_torch_kernels import conv_w8a8_case
from torch_threads import one_torch_thread  # noqa: F401

SIZE = (896, 1408)
MODEL_CALLS = {'ResNet50FPN': 111, 'MobileNetV2FPN': 109}
INT32 = 2 ** 31


def conv_calls(backbone, size, batch=2):
    """[(conv module, input shape)] of every conv call of a forward of
    ``backbone`` on [batch, 3, *size], from fake tensors."""
    module = Model(backbone, classes=80).module
    calls = []
    handles = [m.register_forward_hook(
        lambda mod, args, out: calls.append((mod, tuple(args[0].shape))))
        for m in module.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
            module(torch.empty(batch, 3, *size))
    finally:
        for h in handles:
            h.remove()
    return calls


def call_plan(conv, shape):
    b, c, h, w = shape
    kh, kw = conv.kernel_size
    return kconv.plan(b, c, h, w, conv.out_channels, kh, kw, *conv.stride,
                      *conv.padding, conv.groups)


def parent_blocks(m, n):
    """Blocks of the former one-tile-a-block grid: 128 x 64 tiles for N <=
    64, else 128 x 128, K never split."""
    return -(-m // 128) * -(-n // (64 if n <= 64 else 128))


def cheapest(m, n, k_tiles):
    """(cost, bn, k_per) of the cheapest plan by ``plan_cost`` over every N
    tile no wider than N's own and every slice length: ties to the wider
    tile, then the shorter slice."""
    widest = min(t for t in kconv.TILE_N if t >= min(n, kconv.TILE_N[0]))
    cost, neg_bn, k_per = min(
        (kconv.plan_cost(m, n, k_tiles, t, k), -t, k)
        for t in kconv.TILE_N if t <= widest
        for k in range(1, k_tiles + 1))
    return cost, -neg_bn, k_per


@pytest.mark.parametrize('backbone', list(MODEL_CALLS))
def test_plan_covers_every_call_of_the_model(backbone):
    """The kernel's work units replayed on each call's plan: every output
    pixel and channel in exactly one tile, every K tile in exactly one
    non-empty slice, the workspace as large as the last partial sum's
    index + 1; the plan the cheapest that ``plan_cost`` rates. A call the
    former one-tile-a-block grid ran on fewer blocks than the card has
    SMs gets at least ``SMS`` work units, or else no plan of ``SMS`` units
    or more is rated cheaper. At ResNet50FPN's shapes all 40 such calls
    stop at one round of the grid, 36-120 units where they had 2-80
    blocks: with slices of equal length the next split past 120 units
    (P6's heads: 6 slices of 3 K tiles) is 180 units, two rounds, and
    another finish pass's bytes; the box head at P7 (M = 154) has 36
    (M tile, 64-wide N tile, K tile) triples in all, the most it can
    take; at P5 a split's finish pass (~5 us, measured) costs more than
    the idle SMs do."""
    calls = conv_calls(backbone, SIZE)
    assert len(calls) == MODEL_CALLS[backbone]
    lifted = 0
    for conv, shape in calls:
        p = call_plan(conv, shape)
        b, c, h, w = shape
        n = conv.out_channels
        kh, kw = conv.kernel_size
        assert p.m == b * p.ho * p.wo
        k = kh * kw * kconv.padded(c // conv.groups)
        assert p.k_tiles == -(-k // kconv.TILE_K)
        if conv.groups > 1:
            assert p.route == 'direct' and p.ws_elems == 0
            continue
        dense = (kh, kw, *conv.stride, *conv.padding) == (1, 1, 1, 1, 0, 0)
        assert p.route == ('packed' if c <= kconv.SMALL_CHANNELS
                           else 'dense' if dense else 'gather')
        cost, bn, k_per = cheapest(p.m, n, p.k_tiles)
        assert (p.bn, p.k_per) == (bn, k_per)
        # the work units (tile, K slice), the kernel's index math
        m_cover = np.zeros(p.m, np.int64)
        for y in range(p.m_tiles):
            m_cover[y * kconv.TILE_M:(y + 1) * kconv.TILE_M] += 1
        n_cover = np.zeros(n, np.int64)
        for x in range(p.n_tiles):
            n_cover[x * p.bn:(x + 1) * p.bn] += 1
        assert (m_cover == 1).all() and (n_cover == 1).all()
        assert p.m_tiles * kconv.TILE_M < p.m + kconv.TILE_M
        assert p.n_tiles * p.bn < n + p.bn
        k_cover = np.zeros(p.k_tiles, np.int64)
        for z in range(p.splits):
            kt0 = z * p.k_per
            nk = min(p.k_tiles - kt0, p.k_per)
            assert nk >= 1
            k_cover[kt0:kt0 + nk] += 1
        assert (k_cover == 1).all()
        if p.splits == 1:
            assert p.ws_elems == 0
        else:
            last = ((p.splits - 1) * n + n - 1) * p.m + p.m - 1
            assert p.ws_elems == last + 1
        if parent_blocks(p.m, n) < kconv.SMS:
            lifted += 1
            if p.units < kconv.SMS:
                widest = min(t for t in kconv.TILE_N
                             if t >= min(n, kconv.TILE_N[0]))
                filling = [
                    kconv.plan_cost(p.m, n, p.k_tiles, t, k)
                    for t in kconv.TILE_N if t <= widest
                    for k in range(1, p.k_tiles + 1)
                    if -(-n // t) * p.m_tiles * -(-p.k_tiles // k)
                    >= kconv.SMS]
                assert all(f >= cost for f in filling), (shape, n, p)
                assert p.units >= 36, (shape, n, p)
    if backbone == 'ResNet50FPN':
        assert lifted == 40     # the calls that ran on fewer than 132


def test_plan_routes_and_cache():
    """A 1 x 1 stride-1 unpadded call reads A by TMA, up to 4 input
    channels take the packed route (K = kh kw 4: 196 for the stem's 7 x 7,
    two K tiles where 16 channels a tap took seven), any other ungrouped
    call gathers A, a grouped call runs the direct kernel; the plan is
    made once a shape."""
    kconv.plan.cache_clear()
    dense = kconv.plan(2, 256, 56, 88, 1024, 1, 1, 1, 1, 0, 0, 1)
    assert dense.route == 'dense' and dense.splits == 1
    assert kconv.plan(2, 256, 56, 88, 1024, 1, 1, 2, 2, 0, 0, 1).route == \
        'gather'
    assert kconv.plan(2, 256, 56, 88, 256, 3, 3, 1, 1, 1, 1, 1).route == \
        'gather'
    assert kconv.plan(2, 96, 56, 88, 96, 3, 3, 1, 1, 1, 1, 96).route == \
        'direct'
    stem = kconv.plan(2, 3, 896, 1408, 64, 7, 7, 2, 2, 3, 3, 1)
    assert (stem.route, stem.k_tiles) == ('packed', 2)
    assert kconv.plan(2, 256, 56, 88, 1024, 1, 1, 1, 1, 0, 0, 1) is dense
    assert kconv.plan.cache_info().hits == 1
    assert [kconv.padded(c) for c in (1, 3, 4, 5, 16, 17)] == [
        4, 4, 4, 16, 16, 32]


def replay(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype):
    """The card's path in plain torch: the quantize pass's NHWC copy, the
    A matrix of the GEMM as the producer loads it, the packed weight as TMA
    reads it, each K slice's partial sums and their int32 sum in slice
    order, the rescale. Also holds the dense route's A (the NHWC copy read
    by TMA) equal to the gathered one."""
    b, c, h, w = x.shape
    o, kh, kw, cp = weight_q.shape
    p = kconv.plan(b, c, h, w, o, kh, kw, *stride, *padding, groups)
    assert groups == 1 and p.route != 'direct'
    sh, sw = stride
    ph, pw = padding
    xq = torch.zeros(b, h, w, cp, dtype=torch.int8)
    xq[..., :c] = kconv.quantize_activations(x, act_scale).permute(0, 2, 3, 1)
    k = kh * kw * cp
    kpad = p.k_tiles * kconv.TILE_K
    # the gather: output pixel m, word j of the padded K: 16 bytes, or a
    # tap's 4 on the packed route
    word = 4 if p.route == 'packed' else 16
    m = torch.arange(p.m_tiles * kconv.TILE_M)[:, None]
    kk = torch.arange(0, kpad, word)[None, :]
    bi, pix = m // (p.ho * p.wo), m % (p.ho * p.wo)
    ho, wo = pix // p.wo, pix % p.wo
    row_k = kw * cp
    r = kk // row_k
    s = (kk - r * row_k) // cp
    c0 = kk - r * row_k - s * cp
    hi, wi = ho * sh - ph + r, wo * sw - pw + s
    ok = ((m < p.m) & (kk < k) & (hi >= 0) & (hi < h) & (wi >= 0)
          & (wi < w))
    src = ((bi * h + hi.clamp(0, h - 1)) * w + wi.clamp(0, w - 1)) * cp + c0
    words = xq.reshape(-1)[src[..., None].clamp(0, xq.numel() - word)
                           + torch.arange(word)]
    a = torch.where(ok[..., None], words, 0).reshape(len(m), kpad)
    if p.route == 'dense':
        dense = torch.zeros(p.m_tiles * kconv.TILE_M, kpad, dtype=torch.int8)
        dense[:p.m, :cp] = xq.reshape(p.m, cp)
        assert torch.equal(a, dense)
    wmat = torch.zeros(p.n_tiles * p.bn, kpad, dtype=torch.int8)
    wmat[:o, :k] = weight_q.reshape(o, k)
    acc = torch.zeros(len(m), len(wmat), dtype=torch.int64)
    for z in range(p.splits):
        lo = z * p.k_per * kconv.TILE_K
        hi_k = min(p.k_tiles, (z + 1) * p.k_per) * kconv.TILE_K
        # exact: every partial sum is an integer below 2^53
        part = (a[:, lo:hi_k].double() @ wmat[:, lo:hi_k].double().T).long()
        assert part.abs().max() < INT32
        acc += part
        assert acc.abs().max() < INT32       # the int32 sum never wraps
    acc = acc[:p.m, :o].reshape(b, p.ho, p.wo, o).permute(0, 3, 1, 2)
    y = acc.float() * (act_scale * w_scale)[:, None, None]
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y.to(out_dtype), p


# (b, c, h, w, o, kernel, stride, groups, bias) as test_torch_kernels'
# CONV_CASES: the kinds of ungrouped call at sizes a CPU replays quickly
REPLAY_CASES = {
    'stem_7x7s2_c3': (1, 3, 19, 23, 64, 7, 2, 1, False),
    '1x1_k16': (3, 16, 9, 13, 24, 1, 1, 1, True),
    '1x1_c256_m_tail': (1, 256, 15, 21, 64, 1, 1, 1, False),
    '1x1_s2_downsample': (2, 64, 11, 13, 256, 1, 2, 1, False),
    '3x3s1_odd': (3, 40, 17, 23, 72, 3, 1, 1, True),
    '3x3s2_p6': (1, 512, 7, 11, 256, 3, 2, 1, True),
    'p6_k18432_m6': (1, 2048, 4, 5, 256, 3, 2, 1, True),
    'head_720': (1, 256, 7, 11, 720, 3, 1, 1, True),
    'head_36': (1, 256, 5, 9, 36, 3, 1, 1, True),
    'tiles_cross_images': (3, 64, 9, 15, 128, 3, 1, 1, True),
    'mobilenet_stem_c3': (2, 3, 24, 36, 32, 3, 2, 1, False),
    'one_channel': (1, 1, 20, 30, 16, 3, 1, 1, True),
}


@pytest.mark.parametrize('dtypes', [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('name', list(REPLAY_CASES))
def test_replay_bit_equal_plain(name, dtypes):
    """The kernel's index math and split-K sum equal to the plain version
    bit for bit, NaN and +-inf planted; the P6-like case has K = 18,432
    over M = 6 pixels in 29 slices."""
    in_dtype, out_dtype = dtypes
    args = conv_w8a8_case(*REPLAY_CASES[name], in_dtype, 'cpu')
    want = kconv.conv_w8a8_plain(*args, out_dtype)
    got, p = replay(*args, out_dtype)
    assert torch.equal(got, want)
    if name == 'p6_k18432_m6':
        assert (p.k_tiles, p.m, p.splits) == (144, 6, 29)


def test_replay_resnet18fpn_calls():
    """Every distinct ungrouped conv shape of a ResNet18FPN forward at
    64 x 96, batch 1, replayed and equal to the plain version."""
    shapes = {}
    for conv, shape in conv_calls('ResNet18FPN', (64, 96), batch=1):
        key = (shape[1], shape[2], shape[3], conv.out_channels,
               conv.kernel_size[0], conv.stride[0], conv.padding[0])
        shapes[key] = conv.bias is not None
    assert len(shapes) > 15
    for i, ((c, h, w, o, k, s, pad), bias) in enumerate(sorted(
            shapes.items())):
        args = list(conv_w8a8_case(1, c, h, w, o, k, s, 1, bias,
                                   torch.float32, 'cpu', seed=i))
        args[6] = (pad, pad)
        want = kconv.conv_w8a8_plain(*args, torch.bfloat16)
        got, _ = replay(*args, torch.bfloat16)
        assert torch.equal(got, want), (c, h, w, o, k, s, pad)


@pytest.mark.parametrize('cin', [1, 3, 4, 5, 16, 17, 64])
def test_pack_weight_round_trip(cin):
    """``pack_weight`` lays an OIHW int8 weight out as [O, kh, kw,
    padded(I)] with zeros past I (4 channels a tap up to 4, the stem's 3
    and a depthwise conv's 1), and ``unpack_weight`` gives it back."""
    g = torch.Generator().manual_seed(cin)
    wq = torch.randint(-127, 128, (8, cin, 3, 3), generator=g,
                       dtype=torch.int8)
    packed = kconv.pack_weight(wq)
    assert packed.shape == (8, 3, 3, kconv.padded(cin))
    assert packed.is_contiguous() and not packed[..., cin:].any()
    assert torch.equal(kconv.unpack_weight(packed, cin), wq)


def test_profile_w8a8_sorts_calls_and_kernels():
    """``profile_w8a8``'s call classes from module names (a head conv's
    level from its input's height) and its kernel parts from the kernel
    names of both designs of ``csrc/conv_w8a8.cu``; it imports no JAX
    and measures on a card or fails."""
    import os
    import subprocess
    import sys

    from odtk_tpu_torch import profile_w8a8

    feat = 'backbones.ResNet50FPN.features.'
    x = torch.zeros(2, 256, 28, 44)
    cases = {feat + 'conv1': 'conv1', feat + 'layer1.0.conv1': 'layer1 1x1',
             feat + 'layer2.3.conv2': 'layer2 3x3',
             feat + 'layer4.0.downsample.0': 'layer4 downsample',
             'backbones.ResNet50FPN.lateral5': 'fpn lateral',
             'backbones.ResNet50FPN.pyramid6': 'P6', 'cls_head.4': 'head P5',
             'box_head.8': 'head P5', 'backbones.MobileNetV2FPN.x': 'other'}
    for name, cls in cases.items():
        assert profile_w8a8.call_class(name, x, 896) == cls, name
    parts = {'void (anonymous namespace)::quantize_nhwc_kernel<float>(...)':
             'quantize', 'quantize_nhwc4_kernel': 'quantize',
             'conv_igemm_kernel<float, 64>': 'gemm',
             'conv_wgmma_kernel<256>': 'gemm',
             'conv_finish_kernel': 'finish',
             'conv_direct_kernel<float>': 'direct'}
    for kernel, part in parts.items():
        assert profile_w8a8.kernel_part(kernel) == part, kernel
    code = ('import sys\nbefore = set(sys.modules)\n'
            'import odtk_tpu_torch.profile_w8a8\n'
            'new = {m.split(".")[0] for m in set(sys.modules) - before}\n'
            'print(sorted(new & {"jax", "flax", "jaxlib", "odtk_tpu"}))\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo,
                                  OMP_NUM_THREADS='1'),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == '[]', out.stderr
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match='no CUDA device'):
            profile_w8a8.main([])
