// Detection loss of one FPN level: the masked sigmoid-focal sum over the
// class head, the masked smooth-L1 sum over the box head, and the unit
// gradients of both, in one pass over the heads.
//
// Replaces the TPU kernel odtk_tpu/ops/pallas/focal_kernel.py:
// detection_loss_sums_fused (_loss_fwd_kernel with want_dx). Per element,
// in fp32, with t = (k == cls[b, n]) and depth[b, n] > 0 (the one-hot is
// never built), valid = depth >= 0, fg = depth > 0, and the focal term of
// csrc/focal.cuh (shared with csrc/focal_sum.cu):
//
//   s = sigmoid(x), p_t = t s + (1-t)(1-s), q = 1 - p_t
//   ce = max(x, 0) - x t + log1p(exp(-|x|)),  a_t = t alpha + (1-t)(1-alpha)
//   focal = valid a_t q^gamma ce
//   dx    = valid (-a_t (2t-1) q^gamma (gamma p_t ce + q))
//   d = box - box_t, smooth_l1 = |d| >= beta ? |d| - beta/2 : d^2 / (2 beta)
//   box   = fg smooth_l1,  dbx = fg clamp(d / beta, -1, 1)
//
// Layout: the heads are read where the convolution left them, NCHW
// [B, A*K, H, W] and [B, A*D, H, W] with channel a*K + k; the targets are
// in the heads' anchor-major order, n = (h*W + w)*A + a: cls int32 [B, N],
// depth fp32 [B, N], box_t fp32 [B, N, D]. dx and dbx are written NCHW in
// the heads' dtype, the layout of the tensors whose gradients they are.
//
// Bound on the card: memory bandwidth. At the train shape (b=8, 896x1152
// canvas, A=9, K=80) a step's five levels hold ~124M logits: the bf16 read
// plus the dx write is ~495 MB, the box head, targets and dbx ~62 MB, and
// ~3 transcendentals per logit cost less than the bytes. One thread per
// (b, a, h*w): consecutive threads take consecutive w, so each of the K
// class planes is read and written in coalesced rows; the thread loads its
// anchor's class, depth and D box targets once and reuses them over the K
// classes. Nothing but the two sums and the unit gradients reaches device
// memory.
//
// Deterministic sums: each block reduces its threads' fp32 partials in a
// fixed tree (warp shuffles, then the warps in order) to one pair; a
// second one-block kernel sums the pairs in fp64 in a fixed order. No
// atomics, so the sums are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "focal.cuh"

namespace {

using odtk::focal_term;
using odtk::from_float;
using odtk::to_float;

constexpr int kThreads = 256;

template <typename T>
__global__ void det_loss_kernel(const T* __restrict__ x,
                                const T* __restrict__ bx,
                                const int* __restrict__ cls,
                                const float* __restrict__ depth,
                                const float* __restrict__ bt,
                                T* __restrict__ dx, T* __restrict__ dbx,
                                float* __restrict__ partials, int K, int A,
                                int D, int HW, float alpha, float gamma,
                                float beta) {
  const int hw = blockIdx.x * blockDim.x + threadIdx.x;
  const int ba = blockIdx.y;  // b * A + a
  const int b = ba / A;
  const int a = ba - b * A;
  float cls_sum = 0.f;
  float box_sum = 0.f;
  if (hw < HW) {
    const long long n = ((long long)b * HW + hw) * A + a;
    const float dep = depth[n];
    const int c = cls[n];
    const float valid = dep >= 0.f ? 1.f : 0.f;
    const float fg = dep > 0.f ? 1.f : 0.f;
    const long long xoff = ((long long)b * A + a) * K * HW + hw;
    for (int k = 0; k < K; ++k) {
      const long long o = xoff + (long long)k * HW;
      const float xv = to_float(x[o]);
      const float t = (k == c) ? fg : 0.f;
      float loss, g;
      focal_term(xv, t, alpha, gamma, &loss, &g);
      cls_sum += valid * loss;
      dx[o] = from_float<T>(valid * g);
    }
    const long long boff = ((long long)b * A + a) * D * HW + hw;
    for (int j = 0; j < D; ++j) {
      const long long o = boff + (long long)j * HW;
      const float d = to_float(bx[o]) - bt[n * D + j];
      const float ad = fabsf(d);
      const float sl1 = ad >= beta ? ad - 0.5f * beta : 0.5f * ad * ad / beta;
      box_sum += fg * sl1;
      dbx[o] = from_float<T>(fg * fminf(fmaxf(d / beta, -1.f), 1.f));
    }
  }

  // fixed-order block reduction of the two partial sums
  __shared__ float warp_sums[2][kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    cls_sum += __shfl_down_sync(0xffffffffu, cls_sum, off);
    box_sum += __shfl_down_sync(0xffffffffu, box_sum, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[0][warp] = cls_sum;
    warp_sums[1][warp] = box_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cs = 0.f, bs = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      cs += warp_sums[0][w];
      bs += warp_sums[1][w];
    }
    const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * blk] = cs;
    partials[2 * blk + 1] = bs;
  }
}

// One block sums the per-block pairs in fp64: thread i takes pairs
// i, i + kThreads, ...; then a fixed tree over the threads.
__global__ void det_loss_finish_kernel(const float* __restrict__ partials,
                                       long long nblocks,
                                       float* __restrict__ out) {
  __shared__ double sums[2][kThreads];
  double cs = 0.0, bs = 0.0;
  for (long long i = threadIdx.x; i < nblocks; i += kThreads) {
    cs += partials[2 * i];
    bs += partials[2 * i + 1];
  }
  sums[0][threadIdx.x] = cs;
  sums[1][threadIdx.x] = bs;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sums[0][threadIdx.x] += sums[0][threadIdx.x + half];
      sums[1][threadIdx.x] += sums[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = (float)sums[0][0];
    out[1] = (float)sums[1][0];
  }
}

}  // namespace

// x [B, A*K, H, W], bx [B, A*D, H, W] contiguous, dtype 0 = fp32, 1 = bf16;
// cls int32 [B, N], depth fp32 [B, N], bt fp32 [B, N, D], N = H*W*A
// -> dx, dbx (NCHW, the heads' dtype), out fp32 [2] = (focal sum,
// smooth-L1 sum). partials: fp32 scratch of 2 * nblocks floats, nblocks =
// ceil(HW / 256) * B * A (checked). Returns cudaGetLastError() after the
// launches.
extern "C" int odtk_det_loss(const void* x, const void* bx, const int* cls,
                             const float* depth, const float* bt, void* dx,
                             void* dbx, float* partials, int nblocks,
                             float* out, int dtype, int B, int A, int K,
                             int D, int HW, float alpha, float gamma,
                             float beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((HW + kThreads - 1) / kThreads, B * A);
  if ((long long)grid.x * grid.y != nblocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    det_loss_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(bx), cls,
        depth, bt, static_cast<float*>(dx), static_cast<float*>(dbx),
        partials, K, A, D, HW, alpha, gamma, beta);
  } else if (dtype == 1) {
    det_loss_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(bx), cls, depth, bt,
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dbx),
        partials, K, A, D, HW, alpha, gamma, beta);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  det_loss_finish_kernel<<<1, kThreads, 0, st>>>(partials, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}
