// Masked sigmoid-focal sum of one FPN level (forward) and its gradient
// (backward), two kernels.
//
// Replaces the TPU kernels of odtk_tpu/ops/pallas/focal_kernel.py:
// focal_sum_fused: the forward sum (_fwd_kernel, pallas_call at :123) and
// the backward that recomputes the terms and writes dlogits (_bwd_kernel,
// pallas_call at :147). Per logit, in fp32, with t = (k == cls[b, n]) and
// depth[b, n] > 0 (the one-hot is never built), valid = depth >= 0, and the
// focal term of csrc/focal.cuh:
//
//   sum = sum over valid logits of a_t q^gamma ce
//   dx  = g valid (-a_t (2t-1) q^gamma (gamma p_t ce + q)), in x's dtype
//
// g is the cotangent, read from device memory (no host round trip).
//
// Layout: the class head is the NHWC [B, H, W, A*K] tensor of the JAX
// contract, read in place through its element strides (sB, sC for the
// channel a*K + k, sHW for the merged h*W + w), so the NHWC view of the
// convolution's contiguous NCHW output (sC = H*W, sHW = 1) and a contiguous
// NHWC tensor (sC = 1, sHW = A*K) both work without a copy. cls and depth
// are fp32 [B, N] in the head's anchor-major order, n = (h*W + w)*A + a. dx
// is written with the head's strides.
//
// Bound on the card: memory bandwidth. At the train shape (b=8, 896x1152
// canvas, A=9, K=80) the five levels hold ~124M logits: the forward reads
// ~248 MB of bf16, the backward reads it again and writes as much; ~3
// transcendentals per logit cost less than the bytes. One thread per
// (b, a, h*w): on the NCHW view consecutive threads take consecutive w, so
// each of the K class planes is read (and written) in coalesced rows; the
// thread loads its anchor's class and depth once and reuses them over the K
// classes.
//
// Deterministic sum: each block reduces its threads' fp32 partials in a
// fixed tree (warp shuffles, then the warps in order); a second one-block
// kernel sums the block partials in fp64 in a fixed order. No atomics, so
// the sum is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "focal.cuh"

namespace {

using odtk::focal_term;
using odtk::from_float;
using odtk::to_float;

constexpr int kThreads = 256;

struct Geometry {
  int A, K, HW;
  long long sB, sC, sHW;  // element strides of the head
};

template <typename T>
__global__ void focal_sum_kernel(const T* __restrict__ x,
                                 const float* __restrict__ cls,
                                 const float* __restrict__ depth,
                                 float* __restrict__ partials, Geometry geo,
                                 float alpha, float gamma) {
  const int hw = blockIdx.x * blockDim.x + threadIdx.x;
  const int ba = blockIdx.y;  // b * A + a
  const int b = ba / geo.A;
  const int a = ba - b * geo.A;
  float sum = 0.f;
  if (hw < geo.HW) {
    const long long n = ((long long)b * geo.HW + hw) * geo.A + a;
    const float dep = depth[n];
    if (dep >= 0.f) {
      const int c = (int)cls[n];
      const float fg = dep > 0.f ? 1.f : 0.f;
      const long long xoff = b * geo.sB + (long long)a * geo.K * geo.sC +
                             hw * geo.sHW;
      for (int k = 0; k < geo.K; ++k) {
        float loss, grad;
        focal_term(to_float(x[xoff + k * geo.sC]), (k == c) ? fg : 0.f,
                   alpha, gamma, &loss, &grad);
        sum += loss;
      }
    }
  }

  // fixed-order block reduction
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// One block sums the block partials in fp64: thread i takes partials
// i, i + kThreads, ...; then a fixed tree over the threads.
__global__ void focal_sum_finish_kernel(const float* __restrict__ partials,
                                        long long nblocks,
                                        float* __restrict__ out) {
  __shared__ double sums[kThreads];
  double s = 0.0;
  for (long long i = threadIdx.x; i < nblocks; i += kThreads) {
    s += partials[i];
  }
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)sums[0];
}

template <typename T>
__global__ void focal_sum_dx_kernel(const T* __restrict__ x,
                                    const float* __restrict__ cls,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ g,
                                    T* __restrict__ dx, Geometry geo,
                                    float alpha, float gamma) {
  const int hw = blockIdx.x * blockDim.x + threadIdx.x;
  if (hw >= geo.HW) return;
  const int ba = blockIdx.y;
  const int b = ba / geo.A;
  const int a = ba - b * geo.A;
  const long long n = ((long long)b * geo.HW + hw) * geo.A + a;
  const float dep = depth[n];
  const int c = (int)cls[n];
  const float valid = dep >= 0.f ? 1.f : 0.f;
  const float fg = dep > 0.f ? 1.f : 0.f;
  const float gv = g[0];
  const long long xoff = b * geo.sB + (long long)a * geo.K * geo.sC +
                         hw * geo.sHW;
  for (int k = 0; k < geo.K; ++k) {
    const long long o = xoff + k * geo.sC;
    float loss, grad;
    focal_term(to_float(x[o]), (k == c) ? fg : 0.f, alpha, gamma, &loss,
               &grad);
    dx[o] = from_float<T>(gv * valid * grad);
  }
}

}  // namespace

// x: the head, dtype 0 = fp32, 1 = bf16, addressed by the element strides
// sB, sC, sHW (see the layout note); cls, depth fp32 [B, N], N = HW * A.
// partials: fp32 scratch of nblocks = ceil(HW / 256) * B * A floats
// (checked). out: fp32 [1], the sum. Returns cudaGetLastError() after the
// launches.
extern "C" int odtk_focal_sum(const void* x, const float* cls,
                              const float* depth, float* partials,
                              int nblocks, float* out, int dtype, int B,
                              int A, int K, int HW, long long sB,
                              long long sC, long long sHW, float alpha,
                              float gamma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((HW + kThreads - 1) / kThreads, B * A);
  if ((long long)grid.x * grid.y != nblocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry geo{A, K, HW, sB, sC, sHW};
  if (dtype == 0) {
    focal_sum_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), cls, depth, partials, geo, alpha,
        gamma);
  } else if (dtype == 1) {
    focal_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cls, depth, partials, geo,
        alpha, gamma);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  focal_sum_finish_kernel<<<1, kThreads, 0, st>>>(partials, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}

// The gradient: dx (x's dtype and strides) from x, cls, depth and the
// cotangent g (fp32 [1] on the device). Returns cudaGetLastError() after
// the launch.
extern "C" int odtk_focal_sum_dx(const void* x, const float* cls,
                                 const float* depth, const float* g, void* dx,
                                 int dtype, int B, int A, int K, int HW,
                                 long long sB, long long sC, long long sHW,
                                 float alpha, float gamma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((HW + kThreads - 1) / kThreads, B * A);
  const Geometry geo{A, K, HW, sB, sC, sHW};
  if (dtype == 0) {
    focal_sum_dx_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), cls, depth, g, static_cast<float*>(dx),
        geo, alpha, gamma);
  } else if (dtype == 1) {
    focal_sum_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), cls, depth, g,
        static_cast<__nv_bfloat16*>(dx), geo, alpha, gamma);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
