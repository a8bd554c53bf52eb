"""odtk_tpu_torch ops held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its PyTorch counterpart. The JAX Pallas kernels run as the JAX tests run
them on the CPU: ``nms_pallas`` with ``pallas_call`` forced into
interpret mode, ``fused_bn_relu_pool(interpret=True)``. The kernels
themselves are held against their plain versions in
``test_torch_kernels.py``.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops import anchors as jax_anchors
from odtk_tpu.ops import color as jax_color
from odtk_tpu.ops.decode import decode as jax_decode
from odtk_tpu.ops.decode import decode_fused as jax_decode_fused
from odtk_tpu.ops.nms import nms as jax_nms
from odtk_tpu.ops.pallas import nms_kernel as jax_nms_kernel
from odtk_tpu.ops.pallas import stem_kernel as jax_stem
from odtk_tpu_torch.ops import anchors, color
from odtk_tpu_torch.ops.decode import decode, decode_fused
from odtk_tpu_torch.ops.kernels import nms as knms
from odtk_tpu_torch.ops.kernels import stem as kstem

from test_torch_kernels import nms_case
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Force pallas_call into interpreter mode (no TPU here)."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_nms_kernel.pl, 'pallas_call', patched)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- anchors
@pytest.mark.parametrize('ratios,scales', [
    ((1.0, 2.0, 0.5), tuple(4 * 2 ** (i / 3) for i in range(3))),
    ((0.5, 1.0), (2.0, 3.0, 5.0))])
def test_anchors_match_jax(ratios, scales):
    for stride in (8, 16, 32, 64, 128):
        got = anchors.generate_anchors(stride, ratios, scales)
        want = jax_anchors.generate_anchors(stride, ratios, scales)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- normalize
def test_eval_normalize_u8_matches_jax():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    sizes = np.asarray([[40, 56], [31, 17]], np.float32)
    want = np.asarray(jax_color.eval_normalize_u8(jnp.asarray(u8),
                                                  jnp.asarray(sizes)))
    got = _np(color.eval_normalize_u8(torch.from_numpy(u8),
                                      torch.from_numpy(sizes)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[1, 31:] == 0).all() and (got[1, :, 17:] == 0).all()


# ----------------------------------------------------------------- decode
_LEVELS = [(16, 16, 8), (8, 8, 16), (4, 4, 32)]      # (h, w, stride)


def _heads(seed, a=9, k=5, b=2):
    rng = np.random.RandomState(seed)
    cls = [rng.randn(b, h, w, a * k).astype(np.float32) * 2 - 3
           for h, w, _ in _LEVELS]
    box = [(rng.randn(b, h, w, a * 4) * 0.5).astype(np.float32)
           for h, w, _ in _LEVELS]
    strides = [s for _, _, s in _LEVELS]
    tables = [jax_anchors.generate_anchors(s, (1.0, 2.0, 0.5),
                                           (1.0, 1.26, 1.59))
              for s in strides]
    return cls, box, strides, tables


def _assert_decoded(got, want):
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize('total_top_n,total', [(600, 600), (None, 900)])
def test_decode_fused_matches_jax(total_top_n, total):
    cls, box, strides, tables = _heads(1)
    want = jax_decode_fused(
        [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box],
        strides, tables, threshold=0.75, top_n=300, from_logits=True,
        total_top_n=total_top_n)
    got = decode_fused(
        [torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box],
        strides, tables, threshold=0.75, top_n=300, total_top_n=total_top_n)
    assert _np(got[0]).shape == (2, total)
    assert (_np(got[0]) == 0).any() and (_np(got[0]) > 0).any()
    _assert_decoded(got, want)


@pytest.mark.parametrize('level', range(len(_LEVELS)))
def test_decode_matches_jax_exact(level):
    cls, box, strides, tables = _heads(2)
    c, b, s, t = cls[level], box[level], strides[level], tables[level]
    want = jax_decode(jnp.asarray(c), jnp.asarray(b), s, threshold=0.05,
                      top_n=500, anchors=t, exact=True, from_logits=True)
    got = decode(torch.from_numpy(c), torch.from_numpy(b), s, t,
                 threshold=0.05, top_n=500)
    _assert_decoded(got, want)


# -------------------------------------------------------------------- nms
@pytest.mark.parametrize('kind,n', [('random', 300), ('ties', 300),
                                    ('iou_at_threshold', 300),
                                    ('zeros', 256), ('few_live', 300),
                                    ('random', 1000)])
def test_nms_plain_matches_jax(interpret_pallas, kind, n):
    scores, boxes, classes = nms_case(kind, n=n)
    d = 50
    got = [_np(t) for t in knms.nms_plain(
        torch.from_numpy(scores), torch.from_numpy(boxes),
        torch.from_numpy(classes), 0.5, d)]
    args = (jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(classes),
            0.5, d)
    pallas = [np.asarray(t) for t in jax_nms_kernel.nms_pallas(*args)]
    twin = [np.asarray(t) for t in jax_nms(*args, use_pallas=False)]
    for want in (pallas, twin):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    live = (scores > 0).sum(1)
    kept = (got[0] > 0).sum(1)
    assert (kept <= np.minimum(live, d)).all()
    if kind == 'iou_at_threshold':
        # the box at IoU == 0.5 survives, the one above it does not
        assert np.float32(0.98) in got[0][0]
        assert np.float32(0.97) not in got[0][0]


# ------------------------------------------------------------------- stem
def test_stem_plain_matches_jax_interpret():
    """hp = 32 pooled rows: two 16-row blocks per image in the Pallas
    kernel, so its cross-block rows are exercised."""
    rng = np.random.RandomState(3)
    b, hc, wc, c = 2, 64, 48, 16
    conv = rng.randn(b, hc, wc, c).astype(np.float32)     # NHWC conv1 out
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = rng.randn(c).astype(np.float32)
    merged = np.concatenate([conv[:, :, 0::2], conv[:, :, 1::2]], axis=-1)
    want = np.asarray(jax_stem.fused_bn_relu_pool(
        jnp.asarray(merged), jnp.asarray(scale), jnp.asarray(shift),
        interpret=True))                                   # [B, Hp, Wp, C]
    got = _np(kstem.bn_relu_pool(
        torch.from_numpy(conv.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(scale), torch.from_numpy(shift)))
    assert got.shape == (b, c, hc // 2, wc // 2)
    # rtol 1e-6; atol 1e-6 because XLA contracts the affine into one FMA
    # (one rounding where the plain version rounds twice), a difference of
    # one fp32 ulp of the pre-ReLU value (|value| < 8 here, ulp < 1e-6)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-6,
                               atol=1e-6)
