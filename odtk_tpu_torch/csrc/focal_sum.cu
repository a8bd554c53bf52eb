// Masked sigmoid-focal sum of one FPN level (forward) and its gradient
// (backward), two kernels.
//
// Replaces the TPU kernels of odtk_tpu/ops/pallas/focal_kernel.py:
// focal_sum_fused: the forward sum (_fwd_kernel, pallas_call at :123) and
// the backward that recomputes the terms and writes dlogits (_bwd_kernel,
// pallas_call at :147). Per logit, in fp32, with t = (k == cls[b, n]) and
// depth[b, n] > 0 (the one-hot is never built), valid = depth >= 0, and the
// focal term of csrc/focal.cuh (focal_parts<true>):
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
// NHWC tensor (sC = 1, sHW = A*K) both work without a copy. cls (int32)
// and depth (fp32) are [B, N] in the head's anchor-major order,
// n = (h*W + w)*A + a. dx is written with the head's strides.
//
// Bound on the card: memory bandwidth, then instruction issue. At the
// train shape (b=8, 896x1152 canvas, A=9, K=80) the five levels hold ~124M
// logits: the forward reads ~248 MB of bf16, the backward reads it again
// and writes as much. What the design does about it (csrc/det_loss.cu's,
// row 5's, memory side):
//   - a thread takes 8 consecutive hw of one (b, a) and, for each class k,
//     loads them on the NCHW view as one 16-byte bf16 vector (2 x 16 bytes
//     in fp32, load8 of csrc/focal.cuh), so a warp moves 512 contiguous
//     bytes a request. A level whose HW is not a multiple of 8 (P6, P7 at
//     the train canvas) and a contiguous NHWC head take the scalar path
//     with the same mapping, 8 loads `sHW` elements apart;
//   - the thread's 8 anchors' classes and depths are loaded once for the
//     classes it takes, and folded with alpha (and the cotangent) into a
//     weight a position, 0 where the anchor is ignored;
//   - a level of few positions cuts K into slices, a thread each, so that
//     every launch has ~2^17 threads: one thread walking all 80 classes
//     of P5-P7 ran a latency-bound chain of ~40k instructions;
//   - one accurate exponential a logit (expf), both sigmoid halves from it
//     by one IEEE reciprocal, and log1pf; the vector path and gamma = 2
//     are template parameters, so the loop holds one path.

// Deterministic sum: each block reduces its threads' fp32 partials in a
// fixed tree (warp shuffles, then the warps in order); a second one-block
// kernel sums the block partials in fp64 in a fixed order. No atomics, so
// the sum is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

#include "focal.cuh"

namespace {

using odtk::focal_grad_1exp;
using odtk::focal_loss_1exp;
using odtk::kVec;
using odtk::load8;
using odtk::load_targets;
using odtk::store8;
using odtk::Targets;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 256;
// Threads a launch aims for (~half the card's 132 x 2048): a level with
// fewer (B * A * ceil(HW / 8)) splits its K classes into slices, one a
// thread, so the small levels do not leave a few threads walking all K.
constexpr long long kTargetThreads = 1 << 17;

struct Level {
  const void* x;       // the head
  void* dx;            // backward: the gradient, with the head's strides
  const int* cls;      // [B, HW*A]
  const float* depth;  // [B, HW*A]
  long long sB, sC, sHW;  // element strides of the head
  int B, A, K, HW;
  int chunks;          // ceil(HW / 8): a thread's share of one (b, a)
  int kc, slices;      // classes a slice, slices of K (see make_level)
  int vec;             // 16-byte vectors (see make_level)
  float alpha, gamma;
};

// A thread's work: positions hw0 .. hw0 + count - 1 of anchor a of image
// b, classes k0 .. k1 - 1 (xoff: the head's element offset of class k0 at
// hw0), and the positions' targets.
struct Work {
  int count, k0, k1;
  long long xoff;
  Targets t;
};

__device__ __forceinline__ bool thread_work(const Level& lv, Work* w) {
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= (long long)lv.B * lv.A * lv.slices * lv.chunks) return false;
  const long long row = item / lv.chunks;  // (b, a, slice)
  const int hw0 = static_cast<int>(item - row * lv.chunks) * kVec;
  const int ba = static_cast<int>(row / lv.slices);
  const int slice = static_cast<int>(row - (long long)ba * lv.slices);
  const int b = ba / lv.A;
  const int a = ba - b * lv.A;
  w->count = min(kVec, lv.HW - hw0);
  w->k0 = slice * lv.kc;
  w->k1 = min(lv.K, w->k0 + lv.kc);
  w->xoff = b * lv.sB + ((long long)a * lv.K + w->k0) * lv.sC + hw0 * lv.sHW;
  const long long n0 = ((long long)b * lv.HW + hw0) * lv.A + a;
  w->t = load_targets(lv.cls, lv.depth, n0, lv.A, w->count);
  return true;
}

// The weights of a thread's 8 positions for a positive and for a negative
// target: a_t (forward) or -a_t (2t - 1) times the cotangent (backward),
// 0 at an ignored anchor.
struct Weights {
  float pos[kVec], neg[kVec];
};

__device__ __forceinline__ Weights weights(const Targets& t, float pos,
                                           float neg) {
  Weights w;
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const bool valid = (t.valid >> m) & 1u;
    w.pos[m] = valid ? pos : 0.f;
    w.neg[m] = valid ? neg : 0.f;
  }
  return w;
}

// kVector: the level takes the vector path (Level::vec); kGamma2: gamma is
// 2, q^gamma = q * q. Both compile-time, so a loop holds one path.
template <typename T, bool kVector, bool kGamma2>
__global__ void __launch_bounds__(kThreads)
    focal_sum_kernel(const Level lv, float* __restrict__ partials) {
  const float gamma = kGamma2 ? 2.f : lv.gamma;
  float sum = 0.f;
  Work w;
  if (thread_work(lv, &w)) {
    const Weights a = weights(w.t, lv.alpha, 1.f - lv.alpha);
    const T* xrow = static_cast<const T*>(lv.x) + w.xoff;
#pragma unroll 2
    for (int k = w.k0; k < w.k1; ++k) {
      float v[kVec];
      load8(xrow + (k - w.k0) * lv.sC, kVector, w.count, v, lv.sHW);
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        const bool pos = w.t.cls[m] == k;
        sum += focal_loss_1exp<true>(v[m], pos, pos ? a.pos[m] : a.neg[m],
                                     gamma);
      }
    }
  }

  // fixed-order block reduction
  __shared__ float warp_sums[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += warp_sums[i];
    partials[blockIdx.x] = s;
  }
}

// One block sums the block partials in fp64: thread i takes partials
// i, i + kFinishThreads, ...; then a fixed tree over the threads.
__global__ void __launch_bounds__(kFinishThreads)
    focal_sum_finish_kernel(const float* __restrict__ partials, int nblocks,
                            float* __restrict__ out) {
  __shared__ double sums[kFinishThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kFinishThreads) {
    s += partials[i];
  }
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)sums[0];
}

template <typename T, bool kVector, bool kGamma2>
__global__ void __launch_bounds__(kThreads)
    focal_sum_dx_kernel(const Level lv, const float* __restrict__ g) {
  const float gamma = kGamma2 ? 2.f : lv.gamma;
  Work w;
  if (!thread_work(lv, &w)) return;
  const float gv = g[0];
  const Weights a = weights(w.t, -lv.alpha * gv, (1.f - lv.alpha) * gv);
  const T* xrow = static_cast<const T*>(lv.x) + w.xoff;
  T* dxrow = static_cast<T*>(lv.dx) + w.xoff;
#pragma unroll 2
  for (int k = w.k0; k < w.k1; ++k) {
    float v[kVec];
    load8(xrow + (k - w.k0) * lv.sC, kVector, w.count, v, lv.sHW);
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      const bool pos = w.t.cls[m] == k;
      v[m] = focal_grad_1exp<true>(v[m], pos, pos ? a.pos[m] : a.neg[m],
                                   gamma);
    }
    store8(dxrow + (k - w.k0) * lv.sC, kVector, w.count, v, lv.sHW);
  }
}

// The forward (partials set) or the backward kernel of the instance for
// the level (its path, and gamma == 2) and dtype (0 fp32, 1 bf16); returns
// cudaGetLastError() after the launch.
template <typename T, bool kVector, bool kGamma2>
void launch_kernel(const Level& lv, unsigned grid, cudaStream_t st,
                   float* partials, const float* g) {
  if (partials) {
    focal_sum_kernel<T, kVector, kGamma2><<<grid, kThreads, 0, st>>>(
        lv, partials);
  } else {
    focal_sum_dx_kernel<T, kVector, kGamma2><<<grid, kThreads, 0, st>>>(
        lv, g);
  }
}

template <typename T>
void launch_level(const Level& lv, unsigned grid, cudaStream_t st,
                  float* partials, const float* g) {
  const bool g2 = lv.gamma == 2.f;
  if (lv.vec) {
    (g2 ? launch_kernel<T, true, true>
        : launch_kernel<T, true, false>)(lv, grid, st, partials, g);
  } else {
    (g2 ? launch_kernel<T, false, true>
        : launch_kernel<T, false, false>)(lv, grid, st, partials, g);
  }
}

int launch(int dtype, const Level& lv, unsigned grid, cudaStream_t st,
           float* partials, const float* g) {
  if (dtype == 0) {
    launch_level<float>(lv, grid, st, partials, g);
  } else if (dtype == 1) {
    launch_level<__nv_bfloat16>(lv, grid, st, partials, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The level's descriptor and its block count; false for a shape the
// kernels do not take. A thread takes 8 positions of one (b, a) and the
// classes of one slice of K: K is cut into as few slices as give the
// launch kTargetThreads threads (1 at P3 of the train shape, 80 at P7).
// The vector path needs the 8 positions of a thread adjacent (sHW = 1) and
// every row start 16-byte aligned: HW, sC and sB multiples of 8 and the
// head (and dx) 16-byte aligned.
bool make_level(const void* x, void* dx, const int* cls, const float* depth,
                int B, int A, int K, int HW, long long sB, long long sC,
                long long sHW, float alpha, float gamma, Level* lv,
                long long* blocks) {
  if (B < 0 || A < 1 || K < 1 || HW < 0) return false;
  const int chunks = (HW + kVec - 1) / kVec;
  const long long base = (long long)B * A * chunks;
  const long long want = base > 0 ? (kTargetThreads + base - 1) / base : 1;
  const int split = static_cast<int>(std::min<long long>(want, K));
  const int kc = (K + split - 1) / split;  // classes a slice
  const int slices = (K + kc - 1) / kc;
  *blocks = (base * slices + kThreads - 1) / kThreads;
  if (*blocks >= (1ll << 31)) return false;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  *lv = Level{};
  lv->x = x, lv->dx = dx, lv->cls = cls, lv->depth = depth;
  lv->sB = sB, lv->sC = sC, lv->sHW = sHW;
  lv->B = B, lv->A = A, lv->K = K, lv->HW = HW, lv->chunks = chunks;
  lv->kc = kc, lv->slices = slices;
  lv->vec = sHW == 1 && HW % kVec == 0 && sC % kVec == 0 &&
            sB % kVec == 0 && aligned(x) && (dx == nullptr || aligned(dx));
  lv->alpha = alpha, lv->gamma = gamma;
  return true;
}

}  // namespace

// x: the head, dtype 0 = fp32, 1 = bf16, addressed by the element strides
// sB, sC, sHW (see the layout note); cls int32, depth fp32 [B, N],
// N = HW * A. partials: fp32 scratch of nblocks floats, make_level's
// block count (checked). out: fp32 [1], the sum. Returns the first CUDA
// error of the two launches.
extern "C" int odtk_focal_sum(const void* x, const int* cls,
                              const float* depth, float* partials,
                              int nblocks, float* out, int dtype, int B,
                              int A, int K, int HW, long long sB,
                              long long sC, long long sHW, float alpha,
                              float gamma, void* stream) {
  Level lv;
  long long blocks;
  if (!make_level(x, nullptr, cls, depth, B, A, K, HW, sB, sC, sHW, alpha,
                  gamma, &lv, &blocks) ||
      blocks != nblocks || nblocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch(dtype, lv, nblocks, st, partials, nullptr);
  if (err != 0) return err;
  focal_sum_finish_kernel<<<1, kFinishThreads, 0, st>>>(partials, nblocks,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}

// The gradient: dx (x's dtype and strides) from x, cls, depth and the
// cotangent g (fp32 [1] on the device). Returns cudaGetLastError() after
// the launch.
extern "C" int odtk_focal_sum_dx(const void* x, const int* cls,
                                 const float* depth, const float* g, void* dx,
                                 int dtype, int B, int A, int K, int HW,
                                 long long sB, long long sC, long long sHW,
                                 float alpha, float gamma, void* stream) {
  Level lv;
  long long blocks;
  if (!make_level(x, dx, cls, depth, B, A, K, HW, sB, sC, sHW, alpha, gamma,
                  &lv, &blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0) return 0;
  return launch(dtype, lv, static_cast<unsigned>(blocks),
                static_cast<cudaStream_t>(stream), nullptr, g);
}
