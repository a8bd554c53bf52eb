"""The stem forward's two-pass first max (csrc/stem_pool.cu) replayed on
the CPU, and the stem's NaN rule against the JAX package.

The kernel walks strips of STRIP_ROWS pooled rows of one plane, each
thread a group of GROUP_COLS pooled columns (conv columns 8g-1 .. 8g+7,
the left one from the group before, -inf for the first). Per conv row of
the strip, the halo row 2p0-1 on top, it takes the max over each window's
three columns and the first column that reaches it; then, per window, the
first of its three rows that reaches the window max. A NaN replaces the
running max and stays; a window whose max is not > 0 (0, or NaN) gets the
code 9, which routes no gradient. ``replay_forward`` below repeats that
in plain torch; the tests hold it to ``bn_relu_pool_idx_plain`` (from
max_pool2d's indices) on tie-heavy inputs, across strip and group
boundaries, on odd sizes and with NaN, and hold the gradient it routes to
the JAX package's ``fused_bn_relu_pool`` (its Pallas kernels in interpret
mode under ``jax.vjp``, which route by ``_fwd_idx_kernel``'s codes).

Inputs of the JAX comparisons are exact in fp32 (quarters times scales
of a few bits), so XLA's fused multiply-add gives the values the port's
rounded multiply and add give, ties included, and the gradients (integer
cotangents summed, then scaled) compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops.pallas import stem_kernel as jax_stem
from odtk_tpu_torch.ops.kernels import stem as kstem

from test_torch_kernels import _equal_nan

STRIP_ROWS = 8      # kStripRows of csrc/stem_pool.cu
GROUP_COLS = 4      # kGroupCols


def _takes(v, m):
    """The kernel's replace rule: strictly greater, or a NaN."""
    return (v > m) | v.isnan()


def _first_max(cands):
    """Over the last axis, in order: (max with NaN carried, first index
    that reaches it)."""
    m = cands[..., 0]
    k = torch.zeros(m.shape, dtype=torch.int64)
    for i in range(1, cands.shape[-1]):
        t = _takes(cands[..., i], m)
        m = torch.where(t, cands[..., i], m)
        k = torch.where(t, i, k)
    return m, k


def _row_pass(rows, wc, wp):
    """Pass 1 over post-ReLU conv rows [..., R, Wc]: per group of
    GROUP_COLS pooled columns, its 8 columns and the left one (from the
    group before, -inf for the first group and past the row's end), the
    max over each window's columns and the first column reaching it.
    Returns ([..., R, Wp] maxima, codes 0..2)."""
    ms, ks = [], []
    for g in range(-(-wp // GROUP_COLS)):
        c0 = 2 * GROUP_COLS * g
        cols = torch.full(rows.shape[:-1] + (2 * GROUP_COLS + 1,),
                          -torch.inf)
        lo, hi = max(c0 - 1, 0), min(c0 + 2 * GROUP_COLS, wc)
        cols[..., lo - (c0 - 1):hi - (c0 - 1)] = rows[..., lo:hi]
        q = torch.arange(min(GROUP_COLS, wp - GROUP_COLS * g))
        m, k = _first_max(torch.stack(
            [cols[..., 2 * q], cols[..., 2 * q + 1], cols[..., 2 * q + 2]],
            -1))
        ms.append(m)
        ks.append(k)
    return torch.cat(ms, -1), torch.cat(ks, -1)


def replay_forward(y, scale, shift):
    """The kernel's forward on the CPU: (out fp32 [B, C, Hp, Wp], codes
    int8), strip by strip, the post-ReLU map computed once."""
    b, c, hc, wc = y.shape
    hp, wp = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    z = torch.relu(y.float() * scale.float()[:, None, None]
                   + shift.float()[:, None, None])
    out = torch.empty(b, c, hp, wp)
    idx = torch.empty(b, c, hp, wp, dtype=torch.int8)
    for p0 in range(0, hp, STRIP_ROWS):
        n = min(STRIP_ROWS, hp - p0)
        # conv rows 2p0-1 .. 2(p0+n)-1, -inf outside the map
        rows = torch.full((b, c, 2 * n + 1, wc), -torch.inf)
        lo, hi = max(2 * p0 - 1, 0), min(2 * (p0 + n), hc)
        rows[:, :, lo - (2 * p0 - 1):hi - (2 * p0 - 1)] = z[:, :, lo:hi]
        m, k = _row_pass(rows, wc, wp)
        # pass 2: rows 2p-1, 2p, 2p+1 of each window, in that order
        top, mid, bot = (slice(i, i + 2 * n - 1, 2) for i in range(3))
        w, r = _first_max(torch.stack([m[:, :, top], m[:, :, mid],
                                       m[:, :, bot]], -1))
        col = torch.gather(torch.stack([k[:, :, top], k[:, :, mid],
                                        k[:, :, bot]], -1), -1,
                           r[..., None])[..., 0]
        out[:, :, p0:p0 + n] = w
        idx[:, :, p0:p0 + n] = torch.where(w > 0, 3 * r + col,
                                           kstem.SENTINEL).to(torch.int8)
    return out, idx


def stem_case(kind, shape, seed=0):
    """numpy (y, scale, shift). 'random': normal values; 'levels': quarters
    in [-1, 1.5] (many exact ties, many ReLU zeros); 'plateaus': mostly
    far below 0 (windows of ReLU zeros, code 9) with a few level spikes;
    'neg_inf': levels with -inf planted; 'nan': levels with NaN planted,
    and +-inf in a channel whose scale is 0 (inf * 0 = NaN). Scales and
    shifts are a few bits, so every affine value is exact in fp32."""
    rng = np.random.RandomState(seed)
    b, c, hc, wc = shape
    scale = rng.choice([0.5, 0.75, 1.0, 1.5, 2.0], c).astype(np.float32)
    shift = (rng.randint(-4, 5, c) / 4).astype(np.float32)
    if kind == 'random':
        return (rng.randn(*shape).astype(np.float32),
                (rng.rand(c) + 0.5).astype(np.float32),
                rng.randn(c).astype(np.float32))
    y = (rng.randint(-4, 7, shape) / 4).astype(np.float32)
    if kind == 'plateaus':
        y = np.where(rng.rand(*shape) < 0.9, -8.0, y).astype(np.float32)
    elif kind == 'neg_inf':
        y[rng.rand(*shape) < 0.1] = -np.inf
    elif kind == 'nan':
        y[rng.rand(*shape) < 0.02] = np.nan
        y[0, 0, 0, 0] = np.nan                  # a corner window
        scale[-1] = 0.0
        y[:, -1][rng.rand(b, hc, wc) < 0.05] = np.inf
        y[:, -1][rng.rand(b, hc, wc) < 0.05] = -np.inf
    return y, scale, shift


KINDS = ['random', 'levels', 'plateaus', 'neg_inf', 'nan']
# (B, C, Hc, Wc): two full strips and a part (hp 19), odd Hc and Wc, a
# last group of one column; one strip of one group; two full strips and
# three groups at even sizes; a plane narrower than a group
SHAPES = [(2, 3, 37, 27), (1, 2, 5, 3), (1, 2, 32, 24), (2, 2, 18, 7)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('kind', KINDS)
def test_replay_equals_plain_codes(kind, shape, dtype):
    """bf16 input has denser ties; its pooled value rounds once."""
    y, scale, shift = (torch.from_numpy(a) for a in stem_case(kind, shape))
    y = y.to(dtype)
    out, idx = replay_forward(y, scale, shift)
    want, want_idx = kstem.bn_relu_pool_idx_plain(y, scale, shift)
    assert _equal_nan(out.to(dtype), want)
    assert torch.equal(idx, want_idx)
    assert (idx[out.isnan()] == kstem.SENTINEL).all()
    if kind in ('plateaus', 'nan'):
        assert (idx == kstem.SENTINEL).any()


def _jax_stem(y, scale, shift, g):
    """The JAX package's stem on the NCHW numpy y: (pooled NCHW, dy NCHW
    of the cotangent g NCHW) through ``jax.vjp`` of
    ``fused_bn_relu_pool(interpret=True)``."""
    c = y.shape[1]
    conv = y.transpose(0, 2, 3, 1)                      # NHWC
    merged = np.concatenate([conv[:, :, 0::2], conv[:, :, 1::2]], -1)
    out, vjp = jax.vjp(lambda t: jax_stem.fused_bn_relu_pool(
        t, jnp.asarray(scale), jnp.asarray(shift), interpret=True),
        jnp.asarray(merged))
    dm, = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    dm = np.asarray(dm)
    dy = np.empty_like(conv)
    dy[:, :, 0::2], dy[:, :, 1::2] = dm[..., :c], dm[..., c:]
    return (np.array(out).transpose(0, 3, 1, 2),
            dy.transpose(0, 3, 1, 2))


@pytest.mark.parametrize('kind', ['levels', 'plateaus', 'neg_inf', 'nan'])
def test_replay_routes_like_jax(kind):
    """hp = 16: the JAX argmax forward runs two 8-row blocks an image, the
    replay two strips. Integer cotangents: the routed sums are exact."""
    shape = (2, 3, 32, 24)
    y, scale, shift = stem_case(kind, shape, seed=2)
    hp, wp = shape[2] // 2, shape[3] // 2
    g = np.random.RandomState(3).randint(-8, 9, (2, 3, hp, wp)).astype(
        np.float32)
    want_out, want_dy = _jax_stem(y, scale, shift, g)
    ty, tsc, tsh = (torch.from_numpy(a) for a in (y, scale, shift))
    out, idx = replay_forward(ty, tsc, tsh)
    assert _equal_nan(out, torch.from_numpy(want_out))
    dy = kstem.bn_relu_pool_bwd_plain(idx, torch.from_numpy(g), tsc,
                                      shape[2:])
    np.testing.assert_array_equal(dy.numpy(), want_dy)
    # and the plain version's own autograd, which the CPU path trains with
    yr = ty.clone().requires_grad_(True)
    plain, = torch.autograd.grad(kstem.bn_relu_pool_plain(yr, tsc, tsh),
                                 yr, torch.from_numpy(g))
    np.testing.assert_array_equal(plain.numpy(), want_dy)


def test_plain_matches_jax_interpret_with_nan():
    """Normal values with NaN planted, and +-inf where the scale is 0: the
    plain version's NaNs where the JAX kernel's are, the finite values
    within the tolerance of test_torch_ops.py's stem test (XLA contracts
    the affine into one FMA: one fp32 ulp of the pre-ReLU value)."""
    rng = np.random.RandomState(4)
    shape = (2, 4, 64, 48)
    y = rng.randn(*shape).astype(np.float32)
    y[rng.rand(*shape) < 0.01] = np.nan
    scale = (rng.rand(4) + 0.5).astype(np.float32)
    shift = rng.randn(4).astype(np.float32)
    scale[2] = 0.0
    y[:, 2][rng.rand(2, 64, 48) < 0.02] = np.inf
    y[:, 2][rng.rand(2, 64, 48) < 0.02] = -np.inf
    conv = y.transpose(0, 2, 3, 1)
    merged = np.concatenate([conv[:, :, 0::2], conv[:, :, 1::2]], -1)
    want = np.asarray(jax_stem.fused_bn_relu_pool(
        jnp.asarray(merged), jnp.asarray(scale), jnp.asarray(shift),
        interpret=True)).transpose(0, 3, 1, 2)
    got = kstem.bn_relu_pool(*(torch.from_numpy(a)
                               for a in (y, scale, shift))).numpy()
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
