"""The stem backward's thread layout (csrc/stem_pool.cu) replayed on the CPU.

The kernel runs a thread per (plane, pooled row, column group), threads in
that order from the fastest: group, row, plane, in blocks of 128. A thread
owns pooled columns 4g .. 4g+3 (conv columns 8g .. 8g+7) of pooled row p
of one plane. It loads window rows p and p+1 (the halo, none below the
last row) and writes conv rows 2p (from window row p) and 2p+1 (from
window rows p and p+1). Conv column 8g+7 also lies in window 4g+4: the
thread takes it from the next lane by a warp shuffle, a warp's last lane
loads it itself, and the plane's last group has none. In bf16 each lane
stores its conv rows itself; in fp32 the rows go out staged: each warp's
run of lanes that write one conv row contiguously is copied out from its
first lane's address. ``replay_backward`` below repeats that in torch index arithmetic, thread by
thread as tensors over the threads, and counts the writes; the tests hold
every conv element to one write and the result to
``bn_relu_pool_bwd_plain`` and to the JAX package's VJP of
``fused_bn_relu_pool``, bit for bit: all sum in fp32 in the same order.
"""

import functools

import numpy as np
import pytest
import torch

from odtk_tpu_torch.ops.kernels import stem as kstem

from test_torch_stem_levels import KINDS, _jax_stem, stem_case
from torch_threads import one_torch_thread  # noqa: F401

GROUP_COLS = 4      # kGroupCols
THREADS = 128       # kThreads
WARP = 32


def _take(terms, sc):
    """A conv element's routed sum: for each (codes, values, k) in the
    kernel's order, add the value where the code is k; then the scale."""
    acc = torch.zeros(terms[0][0].shape)
    for codes, vals, k in terms:
        acc = torch.where(codes == k, acc + vals, acc)
    return acc * sc[:, None]


def _route(a, b, sc):
    """Conv rows 2p and 2p+1, columns 8g .. 8g+7 ([threads, 8] each), from
    window rows p (a) and p+1 (b), each (codes, values) of windows 4g ..
    4g+4 ([threads, 5])."""
    (ac, av), (bc, bv) = a, b
    j, j1 = slice(0, GROUP_COLS), slice(1, GROUP_COLS + 1)
    top = [_take([(ac[:, j], av[:, j], 4)], sc),
           _take([(ac[:, j], av[:, j], 5), (ac[:, j1], av[:, j1], 3)], sc)]
    bot = [_take([(ac[:, j], av[:, j], 7), (bc[:, j], bv[:, j], 1)], sc),
           _take([(ac[:, j], av[:, j], 8), (ac[:, j1], av[:, j1], 6),
                  (bc[:, j], bv[:, j], 2), (bc[:, j1], bv[:, j1], 0)], sc)]
    n = sc.shape[0]
    return (torch.stack(top, -1).reshape(n, 2 * GROUP_COLS),
            torch.stack(bot, -1).reshape(n, 2 * GROUP_COLS))


def _shfl_down(x):
    """__shfl_down_sync(mask, x, 1) over the threads: each lane takes the
    next lane's x, a warp's last lane its own (the source is past the
    warp)."""
    w = x.reshape(-1, WARP)
    return torch.cat([w[:, 1:], w[:, -1:]], 1).reshape(-1)


def _run_starts(bulk, gi):
    """Per lane, the first lane of its warp's run (-1 outside any): a run
    starts at a bulk lane that is a warp's first or a plane row's first
    group and takes the bulk lanes after it."""
    bulk, gi = bulk.reshape(-1, WARP), gi.reshape(-1, WARP)
    lane = torch.arange(WARP).expand_as(bulk)
    start = bulk & ((lane == 0) | (gi == 0))
    first = torch.where(start, lane, -1).cummax(1).values
    return torch.where(bulk, first, -1).reshape(-1)


def replay_backward(idx, g, scale, conv_hw):
    """The kernel's backward on the CPU: (dy in g's dtype, the number of
    writes of each conv element [B * C, Hc, Wc])."""
    b, c, hp, wp = g.shape
    hc, wc = conv_hw
    planes = b * c
    groups = -(-wp // GROUP_COLS)
    tid = torch.arange(-(-planes * hp * groups // THREADS) * THREADS)
    gi = tid % groups
    t = tid // groups // hp
    p = tid // groups % hp
    live = t < planes
    own_right = tid % WARP == WARP - 1
    last_group = gi == groups - 1
    plane = torch.where(live, t, 0)
    codes = idx.reshape(planes, hp, wp).long()
    cot = g.float().reshape(planes, hp, wp)
    sc = scale.float()[plane % c]

    def load(r):
        """Window row r: codes and values of windows 4g .. 4g+3 (9 and 0
        where absent), and window 4g+4 where the lane loads it itself."""
        row_ok = live & (r < hp)
        rr = r.clamp(max=hp - 1)
        q = GROUP_COLS * gi[:, None] + torch.arange(GROUP_COLS)
        ok = row_ok[:, None] & (q < wp)
        qq = q.clamp(max=wp - 1)
        code = torch.where(ok, codes[plane[:, None], rr[:, None], qq], 9)
        val = torch.where(ok, cot[plane[:, None], rr[:, None], qq], 0.0)
        q4 = GROUP_COLS * gi + GROUP_COLS
        ok4 = row_ok & own_right & (q4 < wp)
        q4 = q4.clamp(max=wp - 1)
        return (code, val, torch.where(ok4, codes[plane, rr, q4], 9),
                torch.where(ok4, cot[plane, rr, q4], 0.0))

    def unpack(code, val, code4, val4):
        """Window 4g+4 from the next lane (__shfl_down_sync by 1), the
        lane's own load on a warp's last lane, none in the last group."""
        c4 = torch.where(own_right, code4, _shfl_down(code[:, 0]))
        v4 = torch.where(own_right, val4, _shfl_down(val[:, 0]))
        c4 = torch.where(last_group, 9, c4)
        v4 = torch.where(last_group, 0.0, v4)
        return (torch.cat([code, c4[:, None]], 1),
                torch.cat([val, v4[:, None]], 1))

    dy = torch.full((planes, hc, wc), torch.nan)
    writes = torch.zeros(planes, hc, wc, dtype=torch.int64)
    cols = 2 * GROUP_COLS * gi[:, None] + torch.arange(2 * GROUP_COLS)
    # whole 16-byte rows (dy's base is aligned) and the group inside them
    vec = (wc * g.element_size() % 16 == 0) & (cols[:, -1] < wc)
    lane = tid % WARP
    top, bot = unpack(*load(p)), unpack(*load(p + 1))
    for conv_row, vals in zip((2 * p, 2 * p + 1), _route(top, bot, sc)):
        row_ok = live & (conv_row < hc)
        ok = row_ok[:, None] & (cols < wc)
        # where staged, a lane's columns go to its run's first lane's
        # address, one group further for each lane after it
        first = (_run_starts(row_ok & vec, gi) if g.dtype == torch.float32
                 else torch.full_like(tid, -1))
        src = torch.where(first >= 0, tid - lane + first, tid)
        dst_cols = cols[src] + 2 * GROUP_COLS * (tid - src)[:, None]
        th, k = ok.nonzero(as_tuple=True)
        at = (plane[src[th]], conv_row[src[th]], dst_cols[th, k])
        dy.index_put_(at, vals[th, k])
        writes.index_put_(at, torch.ones_like(th), accumulate=True)
    return dy.reshape(b, c, hc, wc).to(g.dtype), writes


# (B, C, Hc, Wc): odd Hc and Wc, one group; odd sizes, wp 10 not a
# multiple of 4; 37 groups a plane, so groups straddle warps, hp 19 and a
# last conv row that only window row 18 holds; the same at wp 148, a
# multiple of 4, with whole 16-byte rows (runs of staged lanes across
# warps and rows); even sizes; a plane narrower than a group; a group's last
# conv column past an odd Wc
SHAPES = [(1, 3, 13, 9), (2, 5, 17, 19), (1, 2, 37, 290), (2, 2, 37, 296),
          (2, 3, 32, 24), (1, 2, 5, 3), (2, 2, 18, 7)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('kind', KINDS)
def test_replay_writes_once_and_equals_plain(kind, shape, dtype):
    """Codes from the plain forward on the case, normal cotangents in the
    working dtype, the dtype's stores: every conv element written once, dy
    equal to plain."""
    y, scale, shift = (torch.from_numpy(a) for a in stem_case(kind, shape))
    y = y.to(dtype)
    _, idx = kstem.bn_relu_pool_idx_plain(y, scale, shift)
    g = torch.from_numpy(np.random.RandomState(7).randn(*idx.shape).astype(
        np.float32)).to(dtype)
    dy, writes = replay_backward(idx, g, scale, shape[2:])
    assert bool((writes == 1).all())
    want = kstem.bn_relu_pool_bwd_plain(idx, g, scale, shape[2:])
    assert dy.dtype == dtype and torch.equal(dy, want)
    if kind in ('plateaus', 'nan'):
        assert (idx == kstem.SENTINEL).any()


# the JAX kernels take even Hc and Wc, and blocks of 4, 8 or 16 pooled
# rows: hp 16; wp 13, not a multiple of 4, and hp 12; 37 groups a plane,
# hp 20
JAX_SHAPES = [(2, 3, 32, 24), (2, 3, 24, 26), (1, 2, 40, 290)]


@functools.cache
def _jax_case(kind, shape):
    """(y, scale, shift, integer cotangent, the JAX package's dy), numpy."""
    y, scale, shift = stem_case(kind, shape, seed=2)
    hp, wp = (shape[2] - 1) // 2 + 1, (shape[3] - 1) // 2 + 1
    g = np.random.RandomState(3).randint(-8, 9, shape[:2] + (hp, wp)).astype(
        np.float32)
    return y, scale, shift, g, _jax_stem(y, scale, shift, g)[1]


@pytest.mark.parametrize('shape', JAX_SHAPES)
@pytest.mark.parametrize('kind', ['levels', 'plateaus', 'neg_inf', 'nan'])
def test_replay_routes_like_jax(kind, shape):
    """The JAX package's VJP on the same numpy inputs, its Pallas kernels
    in interpret mode, through fp32's staged stores. Exact inputs and
    integer cotangents, so every routed sum is exact."""
    y, scale, shift, g, want_dy = _jax_case(kind, shape)
    ty, tsc, tsh = (torch.from_numpy(a) for a in (y, scale, shift))
    _, idx = kstem.bn_relu_pool_idx_plain(ty, tsc, tsh)
    dy, writes = replay_backward(idx, torch.from_numpy(g), tsc, shape[2:])
    assert bool((writes == 1).all())
    np.testing.assert_array_equal(dy.numpy(), want_dy)
