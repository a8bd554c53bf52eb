// Detection loss of all FPN levels of a step: the masked sigmoid-focal sum
// over each class head and the masked smooth-L1 sum over each box head in
// one forward launch (plus a fixed-order finish), and their gradients,
// recomputed from the heads, in one backward launch.
//
// Replaces the TPU kernel odtk_tpu/ops/pallas/focal_kernel.py:
// detection_loss_sums_fused (_loss_fwd_kernel) and the cotangent scale of
// its custom VJP. Per element, in fp32, with t = (k == cls[b, n]) and
// depth[b, n] > 0 (the one-hot is never built), valid = depth >= 0,
// fg = depth > 0, and the focal term of csrc/focal.cuh (focal_parts: one
// exponential a logit):
//
//   focal = valid a_t q^gamma ce,   dx = g_cls valid d focal / dx
//   d = box - box_t, smooth_l1 = |d| >= beta ? |d| - beta/2 : d^2 / (2 beta)
//   box   = fg smooth_l1,           dbx = g_box fg clamp(d / beta, -1, 1)
//
// g_cls and g_box are the cotangents of the level's two sums, read from
// device memory; dx and dbx are rounded once to the heads' dtype.
//
// Layout: per level the heads are read where the convolution left them,
// NCHW [B, A*K, H, W] and [B, A*D, H, W] with channel a*K + k; the targets
// are in the heads' anchor-major order, n = (h*W + w)*A + a: cls int32
// [B, N], depth fp32 [B, N], box_t fp32 [B, N, D]. dx and dbx are written
// NCHW. The levels come as a table of descriptors passed by value (heads,
// targets, HW, the vector flag, the level's first block), so one grid
// covers every level's blocks; a block belongs to one level.
//
// Bound on the card: memory bandwidth. At the train shape (b=8, 896x1152
// canvas, A=9, K=80) a step's five levels hold ~124M logits: the forward
// reads ~248 MB of bf16 and the backward reads as much again and writes it
// once, ~6 bytes a logit over both (the version before this one wrote unit
// gradients in the forward and scaled them in three PyTorch passes, ~24).
// What the design does about it:
//   - vector access: a thread takes 8 consecutive hw of one (b, a) and, for
//     each class k, loads them as one 16-byte bf16 vector (2 x 16 bytes in
//     fp32), so a warp moves 512 contiguous bytes a request; a level whose
//     HW is not a multiple of 8 (P6, P7 at the train canvas) takes the
//     scalar path with the same mapping. The thread's 8 anchors' classes
//     and depths are loaded once for all K classes; box targets and box
//     heads are read only for foreground anchors (the rest have a zero
//     box term and gradient);
//   - one exponential a logit, with the sigmoid and log1p from it;
//   - one launch for the levels, so the small levels (P6: 252 positions,
//     P7: 63) fill a few blocks of 128 threads instead of 72 mostly empty
//     ones each, and the step pays two launches, not ten.
//
// Deterministic sums: each block reduces its threads' fp32 partials in a
// fixed tree (warp shuffles, then the warps in order) to one pair; the
// finish kernel, one block a level, sums the level's pairs in fp64 in a
// fixed order. No atomics, so the sums are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "focal.cuh"

namespace {

using odtk::focal_grad_1exp;
using odtk::focal_loss_1exp;
using odtk::to_float;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 256;
constexpr int kVec = 8;        // consecutive hw positions a thread takes
constexpr int kMaxLevels = 8;
constexpr int kFields = 11;    // int64 fields a level in the host table

struct Level {
  const void* x;       // [B, A*K, HW]
  const void* bx;      // [B, A*D, HW]
  const int* cls;      // [B, HW*A]
  const float* depth;  // [B, HW*A]
  const float* bt;     // [B, HW*A, D]
  void* dx;            // backward only
  void* dbx;
  int hw;
  int vec;             // 16-byte vectors (hw % 8 == 0, aligned pointers)
  int chunks;          // ceil(hw / 8): a thread's share of one (b, a)
  long long block0;    // the level's first block
};

struct Table {
  Level lv[kMaxLevels];
  int levels;
  long long blocks;
  int B, A, K, D;
  float alpha, gamma, beta;
};

// The level of this block (block0 ascending), by compile-time indices so
// the table stays in the parameter bank.
__device__ __forceinline__ int level_of(const Table& t, Level* lv) {
  int l = 0;
  *lv = t.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < t.levels && (long long)blockIdx.x >= t.lv[i].block0) {
      l = i;
      *lv = t.lv[i];
    }
  }
  return l;
}

// 8 values of a row from p: a vector load, or `count` scalar ones.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec,
                                      int count, float v[kVec]) {
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
    for (int m = 0; m < kVec; ++m) v[m] = m < count ? to_float(p[m]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* p, bool vec, int count,
                                      float v[kVec]) {
  if (vec) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m) v[m] = m < count ? p[m] : 0.f;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, bool vec,
                                       int count, const float v[kVec]) {
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
      if (m < count) p[m] = __float2bfloat16_rn(v[m]);
    }
  }
}

__device__ __forceinline__ void store8(float* p, bool vec, int count,
                                       const float v[kVec]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      if (m < count) p[m] = v[m];
    }
  }
}

// A thread's work: 8 positions hw0 .. hw0 + count - 1 of anchor a of
// image b, with their targets: the class of a foreground anchor (-1
// otherwise) and the valid and foreground bits.
struct Work {
  int ba, hw0, count;
  long long n0;  // target index of position hw0
  int tcls[kVec];
  unsigned valid, fg;
};

__device__ __forceinline__ bool thread_work(const Table& t, const Level& lv,
                                            Work* w) {
  const long long item =
      ((long long)blockIdx.x - lv.block0) * kThreads + threadIdx.x;
  if (item >= (long long)t.B * t.A * lv.chunks) return false;
  w->ba = static_cast<int>(item / lv.chunks);
  w->hw0 = static_cast<int>(item - (long long)w->ba * lv.chunks) * kVec;
  w->count = min(kVec, lv.hw - w->hw0);
  const int b = w->ba / t.A;
  const int a = w->ba - b * t.A;
  w->n0 = ((long long)b * lv.hw + w->hw0) * t.A + a;
  w->valid = w->fg = 0u;
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    w->tcls[m] = -1;
    if (m < w->count) {
      const long long n = w->n0 + (long long)m * t.A;
      const float dep = lv.depth[n];
      const int c = lv.cls[n];
      if (dep >= 0.f) w->valid |= 1u << m;
      if (dep > 0.f) {
        w->fg |= 1u << m;
        w->tcls[m] = c;
      }
    }
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    det_loss_fwd_kernel(const Table t, float* __restrict__ partials) {
  Level lv;
  level_of(t, &lv);
  float cls_sum = 0.f;
  float box_sum = 0.f;
  Work w;
  if (thread_work(t, lv, &w)) {
    const T* xrow = static_cast<const T*>(lv.x) +
                    (long long)w.ba * t.K * lv.hw + w.hw0;
#pragma unroll 2
    for (int k = 0; k < t.K; ++k) {
      float v[kVec];
      load8(xrow + (long long)k * lv.hw, lv.vec, w.count, v);
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        const float loss =
            focal_loss_1exp(v[m], w.tcls[m] == k, t.alpha, t.gamma);
        cls_sum += (w.valid >> m) & 1u ? loss : 0.f;
      }
    }
    if (w.fg) {
      const T* bxrow = static_cast<const T*>(lv.bx) +
                       (long long)w.ba * t.D * lv.hw + w.hw0;
      for (int m = 0; m < w.count; ++m) {
        if (!((w.fg >> m) & 1u)) continue;
        const long long n = w.n0 + (long long)m * t.A;
        for (int j = 0; j < t.D; ++j) {
          const float d =
              to_float(bxrow[(long long)j * lv.hw + m]) - lv.bt[n * t.D + j];
          const float ad = fabsf(d);
          box_sum += ad >= t.beta ? ad - 0.5f * t.beta
                                  : 0.5f * ad * ad / t.beta;
        }
      }
    }
  }

  // fixed-order block reduction of the two partial sums
  __shared__ float warp_sums[2][kWarps];
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
    for (int i = 0; i < kWarps; ++i) {
      cs += warp_sums[0][i];
      bs += warp_sums[1][i];
    }
    partials[2 * (long long)blockIdx.x] = cs;
    partials[2 * (long long)blockIdx.x + 1] = bs;
  }
}

// One block a level sums the level's block pairs in fp64: thread i takes
// pairs i, i + kFinishThreads, ...; then a fixed tree over the threads.
__global__ void __launch_bounds__(kFinishThreads)
    det_loss_finish_kernel(const Table t, const float* __restrict__ partials,
                           float* __restrict__ out) {
  long long begin = 0, end = t.blocks;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i == (int)blockIdx.x) begin = t.lv[i].block0;
    if (i == (int)blockIdx.x + 1 && i < t.levels) end = t.lv[i].block0;
  }
  __shared__ double sums[2][kFinishThreads];
  double cs = 0.0, bs = 0.0;
  for (long long i = begin + threadIdx.x; i < end; i += kFinishThreads) {
    cs += partials[2 * i];
    bs += partials[2 * i + 1];
  }
  sums[0][threadIdx.x] = cs;
  sums[1][threadIdx.x] = bs;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sums[0][threadIdx.x] += sums[0][threadIdx.x + half];
      sums[1][threadIdx.x] += sums[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = (float)sums[0][0];
    out[2 * blockIdx.x + 1] = (float)sums[1][0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    det_loss_bwd_kernel(const Table t, const float* __restrict__ g) {
  Level lv;
  const int l = level_of(t, &lv);
  Work w;
  if (!thread_work(t, lv, &w)) return;
  const float g_cls = g[2 * l];
  const float g_box = g[2 * l + 1];
  const long long xoff = (long long)w.ba * t.K * lv.hw + w.hw0;
  const T* xrow = static_cast<const T*>(lv.x) + xoff;
  T* dxrow = static_cast<T*>(lv.dx) + xoff;
#pragma unroll 2
  for (int k = 0; k < t.K; ++k) {
    float v[kVec];
    load8(xrow + (long long)k * lv.hw, lv.vec, w.count, v);
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      const float grad =
          focal_grad_1exp(v[m], w.tcls[m] == k, t.alpha, t.gamma);
      v[m] = (w.valid >> m) & 1u ? g_cls * grad : 0.f;
    }
    store8(dxrow + (long long)k * lv.hw, lv.vec, w.count, v);
  }
  const long long boff = (long long)w.ba * t.D * lv.hw + w.hw0;
  const T* bxrow = static_cast<const T*>(lv.bx) + boff;
  T* dbxrow = static_cast<T*>(lv.dbx) + boff;
  for (int j = 0; j < t.D; ++j) {
    float v[kVec];
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      v[m] = 0.f;
      if (((w.fg >> m) & 1u) && m < w.count) {
        const long long n = w.n0 + (long long)m * t.A;
        const float d =
            to_float(bxrow[(long long)j * lv.hw + m]) - lv.bt[n * t.D + j];
        v[m] = g_box * fminf(fmaxf(d / t.beta, -1.f), 1.f);
      }
    }
    store8(dbxrow + (long long)j * lv.hw, lv.vec, w.count, v);
  }
}

// The table from the host array (kFields int64 a level: x, bx, cls, depth,
// bt, dx, dbx, hw, vec, chunks, block0); false if it is not the one the
// wrapper's level_table builds for these shapes.
bool make_table(const long long* host, int levels, long long blocks, int B,
                int A, int K, int D, float alpha, float gamma, float beta,
                bool backward, Table* t) {
  if (levels < 1 || levels > kMaxLevels || B < 0 || A < 1 || K < 1 ||
      D < 1 || blocks >= (1ll << 31)) {
    return false;
  }
  *t = Table{};
  t->levels = levels;
  t->blocks = blocks;
  t->B = B, t->A = A, t->K = K, t->D = D;
  t->alpha = alpha, t->gamma = gamma, t->beta = beta;
  long long next = 0;
  for (int l = 0; l < levels; ++l) {
    const long long* f = host + (long long)l * kFields;
    Level& lv = t->lv[l];
    lv.x = reinterpret_cast<const void*>(f[0]);
    lv.bx = reinterpret_cast<const void*>(f[1]);
    lv.cls = reinterpret_cast<const int*>(f[2]);
    lv.depth = reinterpret_cast<const float*>(f[3]);
    lv.bt = reinterpret_cast<const float*>(f[4]);
    lv.dx = reinterpret_cast<void*>(f[5]);
    lv.dbx = reinterpret_cast<void*>(f[6]);
    lv.hw = static_cast<int>(f[7]);
    lv.vec = static_cast<int>(f[8]);
    lv.chunks = static_cast<int>(f[9]);
    lv.block0 = f[10];
    if (lv.hw < 0 || lv.chunks != (lv.hw + kVec - 1) / kVec ||
        lv.block0 != next) {
      return false;
    }
    if (lv.vec) {
      const bool aligned =
          lv.hw % kVec == 0 && f[0] % 16 == 0 && f[1] % 16 == 0 &&
          (!backward || (f[5] % 16 == 0 && f[6] % 16 == 0));
      if (!aligned) return false;
    }
    next += ((long long)B * A * lv.chunks + kThreads - 1) / kThreads;
  }
  return next == blocks;
}

}  // namespace

// Forward: table (see make_table) of `levels` levels covering `blocks`
// blocks; dtype 0 = fp32, 1 = bf16 heads; partials: fp32 scratch of
// 2 * blocks floats; out fp32 [levels, 2] = (focal sum, smooth-L1 sum) a
// level. Returns the first CUDA error of the launches.
extern "C" int odtk_det_loss_fwd(const long long* table, int levels,
                                 long long blocks, float* partials,
                                 float* out, int dtype, int B, int A, int K,
                                 int D, float alpha, float gamma, float beta,
                                 void* stream) {
  Table t;
  if (!make_table(table, levels, blocks, B, A, K, D, alpha, gamma, beta,
                  false, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (blocks > 0) {
    if (dtype == 0) {
      det_loss_fwd_kernel<float><<<grid, kThreads, 0, st>>>(t, partials);
    } else if (dtype == 1) {
      det_loss_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          t, partials);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  det_loss_finish_kernel<<<levels, kFinishThreads, 0, st>>>(t, partials,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}

// Backward: the same table with dx, dbx set (NCHW, the heads' dtype), g
// fp32 [levels, 2] the cotangents of the sums, on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int odtk_det_loss_bwd(const long long* table, int levels,
                                 long long blocks, const float* g, int dtype,
                                 int B, int A, int K, int D, float alpha,
                                 float gamma, float beta, void* stream) {
  Table t;
  if (!make_table(table, levels, blocks, B, A, K, D, alpha, gamma, beta,
                  true, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (dtype == 0) {
    det_loss_bwd_kernel<float><<<grid, kThreads, 0, st>>>(t, g);
  } else if (dtype == 1) {
    det_loss_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(t, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
