"""odtk_tpu_torch's masked focal sum (row 6 of the kernel table) held
against the JAX package's ``focal_sum_fused`` on the CPU.

On the CPU ``focal_sum`` is the plain version; the JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_pallas_kernels.py``
does. Inputs are made by numpy from seeds and handed to both. The
tolerances are those of the JAX package's own focal tests (forward rtol
1e-5: fp32 sums of a few hundred terms in other orders; gradient rtol
1e-4, atol 1e-6: the closed-form gradient of the kernel against
autograd's chain through the dense form). The card's tests of the
kernels are in ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops.pallas import focal_sum_fused
from odtk_tpu_torch.ops.kernels import focal

# (seed, b, h, w, a, k): the JAX tests' cases, the last with 6 rows, a
# multiple of no block size (the padded-rows case)
CASES = {'default': (0, 2, 4, 4, 3, 7), 'seed3': (3, 2, 4, 4, 3, 7),
         'nondivisible_rows': (5, 1, 2, 3, 2, 5)}


def _case(seed, b, h, w, a, k):
    rng = np.random.RandomState(seed)
    head = (rng.randn(b, h, w, a * k) * 3).astype(np.float32)
    n = h * w * a
    cls_idx = rng.randint(0, k, (b, n)).astype(np.float32)
    depth = rng.choice([-1.0, 0.0, 2.0], (b, n),
                       p=[0.2, 0.6, 0.2]).astype(np.float32)
    return head, cls_idx, depth, k


@pytest.mark.parametrize('case', sorted(CASES))
def test_focal_sum_matches_jax(case):
    head, cls_idx, depth, k = _case(*CASES[case])
    want = focal_sum_fused(jnp.asarray(head), jnp.asarray(cls_idx),
                           jnp.asarray(depth), classes=k, interpret=True)
    got = focal.focal_sum(torch.from_numpy(head), torch.from_numpy(cls_idx),
                          torch.from_numpy(depth), k)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize('case', sorted(CASES))
def test_focal_sum_grad_matches_jax(case):
    """d(0.37 * sum)/d head: the JAX custom VJP's backward kernel against
    the port's gradient; the targets get none."""
    head, cls_idx, depth, k = _case(*CASES[case])
    want = jax.grad(lambda x: focal_sum_fused(
        x, jnp.asarray(cls_idx), jnp.asarray(depth), classes=k,
        interpret=True) * 0.37)(jnp.asarray(head))
    x = torch.from_numpy(head).requires_grad_(True)
    ci = torch.from_numpy(cls_idx).requires_grad_(True)
    (focal.focal_sum(x, ci, torch.from_numpy(depth), k) * 0.37).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert ci.grad is None or not ci.grad.any()


def test_focal_sum_reads_the_nchw_view_and_bf16():
    """The NHWC view of an NCHW tensor (the layout the convolutions leave
    the heads in) gives the sum of the contiguous head; a bf16 head gets a
    bf16 gradient, the sum of its fp32 values."""
    head, cls_idx, depth, k = _case(*CASES['default'])
    x = torch.from_numpy(head)
    view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    ci, dp = torch.from_numpy(cls_idx), torch.from_numpy(depth)
    assert focal.focal_sum(view, ci, dp, k).item() == \
        focal.focal_sum(x, ci, dp, k).item()
    xb = x.bfloat16().requires_grad_(True)
    s = focal.focal_sum(xb, ci, dp, k)
    s.backward()
    assert xb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        s.item(), focal.focal_sum(xb.detach().float(), ci, dp, k).item(),
        rtol=1e-6)


@pytest.mark.parametrize('case', sorted(CASES))
def test_focal_sum_plain_float64_gradient_is_the_closed_form(case):
    """On float64 logits the plain version computes in float64, and its
    autograd gradient (the reference the card's checks hold the backward
    kernel to) equals the closed form -a_t (2t-1) q^2 (2 p_t ce + q) of the
    kernels, evaluated here in numpy, within a relative 1e-12."""
    head, cls_idx, depth, k = _case(*CASES[case])
    x = torch.from_numpy(head).double().requires_grad_(True)
    s = focal.focal_sum_plain(x, torch.from_numpy(cls_idx),
                              torch.from_numpy(depth), k)
    assert s.dtype == torch.float64
    got, = torch.autograd.grad(s, x, torch.tensor(0.37, dtype=torch.float64))
    xv = head.astype(np.float64).reshape(head.shape[0], -1, k)
    t = ((cls_idx[..., None] == np.arange(k)) & (depth > 0)[..., None])
    sig = 1 / (1 + np.exp(-xv))
    p_t = np.where(t, sig, 1 - sig)
    q = 1 - p_t
    a_t = np.where(t, 0.25, 0.75)
    want = (-a_t * (2 * t - 1) * q ** 2 * (2 * p_t * -np.log(p_t) + q)
            * (depth >= 0)[..., None] * 0.37)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               rtol=1e-12, atol=0)


# ------------------------------------------- the kernels' one-exponential form
def one_exp_terms(x, t, alpha=0.25, gamma=2.0):
    """The CUDA kernels' arithmetic (csrc/focal.cuh, focal_parts<true>) in
    torch fp32: e = exp(-|x|), both sigmoid halves from one reciprocal of
    1 + e, p_t the one that agrees with the target, q the other, and
    ce = log1p(e) + (0 where they agree, else |x|). Returns (loss, d
    loss / dx) a logit."""
    x = x.float()
    ax = x.abs()
    e = torch.exp(-ax)
    big = torch.reciprocal(1.0 + e)
    small = e * big
    agree = t == (x >= 0)
    p_t = torch.where(agree, big, small)
    q = torch.where(agree, small, big)
    ce = torch.log1p(e) + torch.where(agree, 0.0, ax)
    qg = q * q if gamma == 2.0 else q ** gamma
    loss = torch.where(t, alpha, 1.0 - alpha) * qg * ce
    grad = torch.where(t, -alpha, 1.0 - alpha) * qg * (gamma * p_t * ce + q)
    return loss, grad


def replay_focal_sum(head, cls_idx, depth, k, g):
    """The kernels on the CPU: (the sum over valid logits, summed in
    float64 as the kernels' finish does; dx = g valid d loss / dx in the
    head's dtype)."""
    b = head.shape[0]
    x = head.reshape(b, -1, k)
    t = ((cls_idx.long()[..., None] == torch.arange(k))
         & (depth > 0)[..., None])
    valid = (depth >= 0)[..., None]
    loss, grad = one_exp_terms(x, t)
    total = torch.where(valid, loss, 0.0).double().sum().float()
    dx = torch.where(valid, g * grad, 0.0).to(head.dtype)
    return total, dx.reshape(head.shape)


def _extreme_case(seed, dtype):
    """B = 2, 3 x 5 positions, A = 3, K = 5, logits of +-30 and 0 planted
    among random ones of scale 4, ignored, background and foreground
    anchors."""
    head, cls_idx, depth, k = _case(seed, 2, 3, 5, 3, 5)
    rng = np.random.RandomState(seed + 100)
    flat = head.reshape(-1)
    flat[:] = rng.randn(flat.size).astype(np.float32) * 4
    spots = rng.choice(flat.size, 60, replace=False)
    flat[spots[:20]], flat[spots[20:40]], flat[spots[40:]] = 30.0, -30.0, 0.0
    head = torch.from_numpy(head).to(dtype).float().numpy()
    return head, cls_idx, depth, k


# phase 6 of chip_smoke.py: the sum within a relative 1e-6; dx within one
# bf16 ulp (bf16) or FOCAL_DX_RTOL = 1e-5 (fp32), plus FOCAL_DX_ATOL = 1e-10
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('seed', [0, 7])
def test_one_exp_replay_matches_jax_and_float64(dtype, seed):
    """The kernels' one-exponential arithmetic, replayed in fp32, against
    ``focal_sum_fused`` (interpret mode) and its ``jax.grad``, and against
    the plain version's autograd in float64, within phase 6's tolerances,
    on logits of +-30 and 0 among random ones, bf16 and fp32 heads. At a
    logit of exactly 0 autograd of the plain form takes the subgradients
    of its clamp and abs: those elements are held to the derivative
    against the JAX kernel only."""
    head, cls_idx, depth, k = _extreme_case(seed, dtype)
    x = torch.from_numpy(head).to(dtype)
    ci, dp = torch.from_numpy(cls_idx), torch.from_numpy(depth)
    total, dx = replay_focal_sum(x, ci, dp, k, 0.37)
    want = float(focal_sum_fused(jnp.asarray(head), jnp.asarray(cls_idx),
                                 jnp.asarray(depth), classes=k,
                                 interpret=True))
    assert abs(total.item() - want) <= 1e-6 * abs(want)
    x64 = x.double().requires_grad_(True)
    s64 = focal.focal_sum_plain(x64, ci, dp, k)
    assert abs(total.item() - s64.item()) <= 1e-6 * abs(s64.item())
    ref, = torch.autograd.grad(s64, x64, torch.tensor(0.37,
                                                      dtype=torch.float64))
    jdx = torch.from_numpy(np.asarray(jax.grad(lambda v: focal_sum_fused(
        v, jnp.asarray(cls_idx), jnp.asarray(depth), classes=k,
        interpret=True) * 0.37)(jnp.asarray(head)))).double()
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    if dtype == torch.bfloat16:
        ref = ref.bfloat16().double()
        jdx = jdx.bfloat16().double()
    nz = x != 0
    got = dx.double()
    torch.testing.assert_close(got[nz], ref[nz], rtol=rtol, atol=1e-10)
    torch.testing.assert_close(got, jdx, rtol=rtol, atol=1e-10)
    assert (x.abs() == 30).sum() == 40 and (x == 0).sum() >= 20


def test_focal_kernel_wrappers_refuse_cpu_tensors():
    """The kernels take CUDA tensors only: there is no fallback."""
    head, cls_idx, depth, k = _case(*CASES['default'])
    args = (torch.from_numpy(head), torch.from_numpy(cls_idx),
            torch.from_numpy(depth))
    with pytest.raises(ValueError, match='CUDA'):
        focal.focal_sum_kernel(*args, k)
    with pytest.raises(ValueError, match='CUDA'):
        focal.focal_sum_dx_kernel(*args, torch.tensor(1.0), k)
