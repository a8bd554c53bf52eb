// The sigmoid-focal term of one logit and the fp32 <-> storage conversions:
// shared by csrc/det_loss.cu and csrc/focal_sum.cu.
//
// Per logit x, in fp32, with t in {0, 1} the one-hot target (never built in
// memory: the callers compare the class index with k):
//
//   s = sigmoid(x), p_t = t s + (1-t)(1-s), q = 1 - p_t
//   ce = max(x, 0) - x t + log1p(exp(-|x|))       (= -log p_t, stable)
//   a_t = t alpha + (1-t)(1-alpha)
//   loss = a_t q^gamma ce
//   grad = -a_t (2t-1) q^gamma (gamma p_t ce + q)  (d loss / d x)
//
// the math of odtk_tpu/ops/pallas/focal_kernel.py:_terms. The
// d(p_t)/dx = s(1-s)(2t-1) factor contracts with 1/p_t into p_t q, so the
// gradient stays finite as p_t -> 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace odtk {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The focal loss of logit xv against target t, and its derivative.
__device__ __forceinline__ void focal_term(float xv, float t, float alpha,
                                           float gamma, float* loss,
                                           float* grad) {
  const float s = 1.f / (1.f + expf(-xv));
  const float ce = fmaxf(xv, 0.f) - xv * t + log1pf(expf(-fabsf(xv)));
  const float p_t = t * s + (1.f - t) * (1.f - s);
  const float q = 1.f - p_t;
  const float qg = gamma == 2.f ? q * q : powf(q, gamma);
  const float a_t = t * alpha + (1.f - t) * (1.f - alpha);
  *loss = a_t * qg * ce;
  *grad = -a_t * (2.f * t - 1.f) * qg * (gamma * p_t * ce + q);
}

// log(1 + e) for 0 <= e <= 1, as e P(e): P a degree-8 least-squares fit
// of log1p(e) / e on Chebyshev nodes of [0, 1] (relative error under
// 2e-7 in fp32 over the interval, tiny e included), in fused multiply-adds
// and no special-function unit.
__device__ __forceinline__ float log1p_unit(float e) {
  float p = 0.005253457930f;
  p = fmaf(p, e, -0.02958850749f);
  p = fmaf(p, e, 0.07836166769f);
  p = fmaf(p, e, -0.1367477030f);
  p = fmaf(p, e, 0.1911143064f);
  p = fmaf(p, e, -0.2484436929f);
  p = fmaf(p, e, 0.3331927061f);
  p = fmaf(p, e, -0.4999950230f);
  p = fmaf(p, e, 1.f);
  return e * p;
}

// The same term from one exponential a logit (csrc/det_loss.cu), in the
// hardware's fast exponential and reciprocal (a few ulps each, relative
// errors ~1e-6 against ~1e-7 for focal_term) and log1p_unit: with e = exp(-|x|),
// sigmoid(|x|) = 1 / (1 + e) and sigmoid(-|x|) = e / (1 + e); p_t is the
// first where the target agrees with the sign of x and the second
// elsewhere, and q = 1 - p_t the other one (no 1 - p cancellation), so
// ce = -log p_t = log1p(e) + (agree ? 0 : |x|). t is the target bit.
__device__ __forceinline__ void focal_parts(float xv, bool t, float* q,
                                            float* p_t, float* ce) {
  const float ax = fabsf(xv);
  const float e = __expf(-ax);
  const float big = __fdividef(1.f, 1.f + e);
  const float small = e * big;
  const bool agree = t == (xv >= 0.f);
  *p_t = agree ? big : small;
  *q = agree ? small : big;
  *ce = log1p_unit(e) + (agree ? 0.f : ax);
}

__device__ __forceinline__ float focal_loss_1exp(float xv, bool t,
                                                 float alpha, float gamma) {
  float q, p_t, ce;
  focal_parts(xv, t, &q, &p_t, &ce);
  const float qg = gamma == 2.f ? q * q : powf(q, gamma);
  return (t ? alpha : 1.f - alpha) * qg * ce;
}

// d loss / dx = -a_t (2t-1) q^gamma (gamma p_t ce + q)
__device__ __forceinline__ float focal_grad_1exp(float xv, bool t,
                                                 float alpha, float gamma) {
  float q, p_t, ce;
  focal_parts(xv, t, &q, &p_t, &ce);
  const float qg = gamma == 2.f ? q * q : powf(q, gamma);
  return (t ? -alpha : 1.f - alpha) * qg * (gamma * p_t * ce + q);
}

}  // namespace odtk
