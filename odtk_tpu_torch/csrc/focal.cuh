// The sigmoid-focal term of one logit, the 8-wide row loads and stores and
// the targets of a thread's 8 anchors: shared by csrc/det_loss.cu and
// csrc/focal_sum.cu.
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
#include <cstdint>

namespace odtk {

constexpr int kVec = 8;  // consecutive hw positions a thread takes

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// The term's parts from one exponential a logit: with e = exp(-|x|),
// sigmoid(|x|) = 1 / (1 + e) and sigmoid(-|x|) = e / (1 + e); p_t is the
// first where the target agrees with the sign of x and the second
// elsewhere, and q = 1 - p_t the other one (no 1 - p cancellation), so
// ce = -log p_t = log1p(e) + (agree ? 0 : |x|). t is the target bit.
// kAccurate: the library's expf and log1pf and an IEEE reciprocal
// (csrc/focal_sum.cu, held to the float64 gradient within 1e-5); else the
// hardware's fast exponential and reciprocal (a few ulps each) and
// log1p_unit (csrc/det_loss.cu, held within one bf16 ulp).
template <bool kAccurate>
__device__ __forceinline__ void focal_parts(float xv, bool t, float* q,
                                            float* p_t, float* ce) {
  const float ax = fabsf(xv);
  const float e = kAccurate ? expf(-ax) : __expf(-ax);
  const float big =
      kAccurate ? __frcp_rn(1.f + e) : __fdividef(1.f, 1.f + e);
  const float small = e * big;
  const bool agree = t == (xv >= 0.f);
  *p_t = agree ? big : small;
  *q = agree ? small : big;
  *ce = (kAccurate ? log1pf(e) : log1p_unit(e)) + (agree ? 0.f : ax);
}

// w q^gamma ce: the loss with w = a_t, or a_t times a scale.
template <bool kAccurate>
__device__ __forceinline__ float focal_loss_1exp(float xv, bool t, float w,
                                                 float gamma) {
  float q, p_t, ce;
  focal_parts<kAccurate>(xv, t, &q, &p_t, &ce);
  const float qg = gamma == 2.f ? q * q : powf(q, gamma);
  return w * qg * ce;
}

// w q^gamma (gamma p_t ce + q): d loss / dx = -a_t (2t-1) q^gamma (gamma
// p_t ce + q) with w = -a_t (2t-1), or that times a scale.
template <bool kAccurate>
__device__ __forceinline__ float focal_grad_1exp(float xv, bool t, float w,
                                                 float gamma) {
  float q, p_t, ce;
  focal_parts<kAccurate>(xv, t, &q, &p_t, &ce);
  const float qg = gamma == 2.f ? q * q : powf(q, gamma);
  return w * qg * (gamma * p_t * ce + q);
}

// 8 values of a row from p: a 16-byte vector load (two in fp32) where
// `vec` (p 16-byte aligned, the 8 values adjacent), else `count` scalar
// loads `step` elements apart and zeros after them.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec,
                                      int count, float v[kVec],
                                      long long step = 1) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      v[m] = m < count ? to_float(p[m * step]) : 0.f;
    }
  }
}

__device__ __forceinline__ void load8(const float* p, bool vec, int count,
                                      float v[kVec], long long step = 1) {
  if (vec) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m) v[m] = m < count ? p[m * step] : 0.f;
  }
}

// The first `count` of v to p, rounded once to p's type: load8's layout.
__device__ __forceinline__ void store8(__nv_bfloat16* p, bool vec,
                                       int count, const float v[kVec],
                                       long long step = 1) {
  if (vec) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(
                  __float2bfloat16_rn(v[2 * i + 1])))
              << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      if (m < count) p[m * step] = __float2bfloat16_rn(v[m]);
    }
  }
}

__device__ __forceinline__ void store8(float* p, bool vec, int count,
                                       const float v[kVec],
                                       long long step = 1) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      if (m < count) p[m * step] = v[m];
    }
  }
}

// The targets of a thread's positions: anchors n0, n0 + A, ... (`count` of
// them, the anchor-major order of 8 consecutive hw of one anchor a), each
// read once for all K classes: the class of a foreground anchor (-1
// otherwise), and the valid (depth >= 0) and foreground (depth > 0) bits.
struct Targets {
  int cls[kVec];
  unsigned valid, fg;
};

__device__ __forceinline__ Targets load_targets(const int* cls,
                                                const float* depth,
                                                long long n0, int A,
                                                int count) {
  Targets t;
  t.valid = t.fg = 0u;
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    t.cls[m] = -1;
    if (m < count) {
      const long long n = n0 + (long long)m * A;
      const float dep = depth[n];
      const int c = cls[n];
      if (dep >= 0.f) t.valid |= 1u << m;
      if (dep > 0.f) {
        t.fg |= 1u << m;
        t.cls[m] = c;
      }
    }
  }
  return t;
}

}  // namespace odtk
