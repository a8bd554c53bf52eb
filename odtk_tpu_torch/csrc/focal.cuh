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

}  // namespace odtk
