// ResNet stem tail: folded BN affine -> ReLU -> 3x3 / stride 2 / pad 1 max
// pool, in one pass over the stem conv's output, and its gradient.
//
// Replaces the three kernels of the TPU op odtk_tpu/ops/pallas/
// stem_kernel.py:fused_bn_relu_pool: the primal forward (_fwd_kernel,
// stem_pool_kernel below), the forward that also saves the window argmax
// under autodiff (_fwd_idx_kernel, stem_pool_idx_kernel) and the backward
// (_bwd_kernel, stem_pool_bwd_kernel). They compute what those kernels
// compute, not their layout: the input is the plain NCHW conv1 output
// [B, C, Hc, Wc], not the TPU's merged even/odd-column phase layout.
//
//   out[b, c, p, q] = max over rows 2p-1..2p+1, cols 2q-1..2q+1 of
//                     relu(y[b, c, row, col] * scale[c] + shift[c])
//
// with padding counted as -inf (every window holds at least one real
// element). The affine runs in fp32 as a rounded multiply then a rounded add
// (no FMA contraction), the maximum is taken in fp32 and rounded once to the
// output type, so the result equals
// max_pool2d(relu(y.float() * scale + shift), 3, 2, 1).to(y.dtype) bit for
// bit.
//
// Bound on the card: memory bandwidth. Each output reads up to nine inputs
// and does ~30 flops, far below the H100's flop/byte balance. The plain
// version makes four passes over the full-resolution map (the fp32 cast, the
// affine, the ReLU, the pool) and keeps fp32 intermediates in device memory;
// this kernel reads the conv output once and writes only the pooled quarter,
// so the post-ReLU map never reaches device memory. One thread per output
// element, consecutive threads on consecutive q, so the stores are
// coalesced and the loads of a warp span a contiguous 2*32-column strip of
// three rows; the overlap between neighbouring windows is served from L1/L2.
// The forward with argmax adds a one-byte store per output. The backward is
// a gather over the conv map (one thread per 2x2 quad, reading the four
// windows that hold it), so every element is written once, with no
// atomics and no data-dependent loads; its bytes are the dy write plus the
// idx and g reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

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

// Launch shape of all three kernels: one thread per pooled element (per
// 2x2 quad of conv elements in the backward), x over the pooled columns,
// y over the pooled rows, z over the B*C planes, so a thread's coordinates
// come from its block and thread indices without a 64-bit division.
constexpr int kThreads = 128;

__host__ __device__ inline unsigned col_blocks(int width) {
  return (unsigned)((width + kThreads - 1) / kThreads);
}

template <typename T>
__global__ void stem_pool_kernel(const T* __restrict__ y,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift,
                                 T* __restrict__ out, int C, int hc, int wc,
                                 int hp, int wp) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= wp) return;
  const int p = blockIdx.y;
  const long long t = blockIdx.z;  // plane index b * C + c
  const int ch = (int)(blockIdx.z % (unsigned)C);
  const T* plane = y + t * hc * wc;
  const float sc = scale[ch];
  const float sh = shift[ch];

  float m = -INFINITY;
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const int r = 2 * p + dr;
    if (r < 0 || r >= hc) continue;
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const int col = 2 * q + dc;
      if (col < 0 || col >= wc) continue;
      const float v = __fadd_rn(__fmul_rn(to_float(plane[r * wc + col]), sc),
                                sh);
      m = fmaxf(m, fmaxf(v, 0.f));
    }
  }
  out[(t * hp + p) * wp + q] = from_float<T>(m);
}

// As stem_pool_kernel, plus idx[o]: the window's first maximum as a
// candidate code 0..8, row-major over (rows 2p-1, 2p, 2p+1) x (cols 2q-1,
// 2q, 2q+1), the order in which torch's max_pool2d keeps its first max; 9
// when the post-ReLU max is 0, where the ReLU kills the window's gradient.
// Pad positions are never candidates. out equals stem_pool_kernel's.
template <typename T>
__global__ void stem_pool_idx_kernel(const T* __restrict__ y,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     T* __restrict__ out,
                                     signed char* __restrict__ idx, int C,
                                     int hc, int wc, int hp, int wp) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= wp) return;
  const int p = blockIdx.y;
  const long long t = blockIdx.z;
  const int ch = (int)(blockIdx.z % (unsigned)C);
  const T* plane = y + t * hc * wc;
  const float sc = scale[ch];
  const float sh = shift[ch];

  float m = -INFINITY;
  int best = 9;
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const int r = 2 * p + dr;
    if (r < 0 || r >= hc) continue;
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      const int col = 2 * q + dc;
      if (col < 0 || col >= wc) continue;
      const float v = fmaxf(
          __fadd_rn(__fmul_rn(to_float(plane[r * wc + col]), sc), sh), 0.f);
      if (v > m) {
        m = v;
        best = 3 * (dr + 1) + (dc + 1);
      }
    }
  }
  const long long o = (t * hp + p) * wp + q;
  out[o] = from_float<T>(m);
  idx[o] = (signed char)(m > 0.f ? best : 9);
}

// Backward: a gather, one thread per 2x2 quad of conv elements, rows
// (2p, 2p+1) x cols (2q, 2q+1). Those four elements lie only in the windows
// (p, q), (p, q+1), (p+1, q) and (p+1, q+1), so the thread reads the four
// codes and cotangents once, unconditionally, and writes four outputs:
//   dy[b, c, i, j] = scale[c] * sum of g[b, c, p', q'] over the windows
//                    (p', q') that hold (i, j) and whose idx points at it,
// summed in fp32 in the order of ascending p', then q' (the order of
// max_pool2d's own backward), then cast to y's dtype. No atomics.
template <typename T>
__global__ void stem_pool_bwd_kernel(const signed char* __restrict__ idx,
                                     const T* __restrict__ g,
                                     const float* __restrict__ scale,
                                     T* __restrict__ dy, int C, int hc,
                                     int wc, int hp, int wp) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= wp) return;
  const int p = blockIdx.y;
  const long long t = blockIdx.z;  // plane index b * C + c
  const float sc = scale[blockIdx.z % (unsigned)C];
  const signed char* ip = idx + t * hp * wp;
  const T* gp = g + t * hp * wp;

  // window (p + a, q + b): its code, and its cotangent (0 where absent)
  int code[2][2];
  float gv[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const bool live = p + a < hp && q + b < wp;
      const long long o = (long long)(p + a) * wp + (q + b);
      code[a][b] = live ? ip[o] : 9;
      gv[a][b] = live ? to_float(gp[o]) : 0.f;
    }
  }
  // the code of conv element (2p + r, 2q + c) in window (p + a, q + b):
  // row offset r - 2a + 1, column offset c - 2b + 1, row-major
#define STEM_TAKE(r, c, a, b)                                   \
  if (code[a][b] == 3 * ((r) - 2 * (a) + 1) + ((c) - 2 * (b) + 1)) \
    acc += gv[a][b];
  T* row = dy + (t * hc + 2 * p) * wc + 2 * q;
  const bool col1 = 2 * q + 1 < wc;
  float acc = 0.f;
  STEM_TAKE(0, 0, 0, 0)
  row[0] = from_float<T>(__fmul_rn(acc, sc));
  if (col1) {
    acc = 0.f;
    STEM_TAKE(0, 1, 0, 0)
    STEM_TAKE(0, 1, 0, 1)
    row[1] = from_float<T>(__fmul_rn(acc, sc));
  }
  if (2 * p + 1 < hc) {
    row += wc;
    acc = 0.f;
    STEM_TAKE(1, 0, 0, 0)
    STEM_TAKE(1, 0, 1, 0)
    row[0] = from_float<T>(__fmul_rn(acc, sc));
    if (col1) {
      acc = 0.f;
      STEM_TAKE(1, 1, 0, 0)
      STEM_TAKE(1, 1, 0, 1)
      STEM_TAKE(1, 1, 1, 0)
      STEM_TAKE(1, 1, 1, 1)
      row[1] = from_float<T>(__fmul_rn(acc, sc));
    }
  }
#undef STEM_TAKE
}

// The grid over a [planes, rows, width] map, or a zero grid when a
// dimension exceeds the card's limits (the caller then reports
// cudaErrorInvalidValue).
dim3 grid_for(int planes, int rows, int width) {
  if (planes <= 0 || rows <= 0 || width <= 0 || planes > 65535 ||
      rows > 65535) {
    return dim3(0, 0, 0);
  }
  return dim3(col_blocks(width), (unsigned)rows, (unsigned)planes);
}

}  // namespace

// y [B, C, hc, wc] contiguous on the device, dtype 0 = fp32, 1 = bf16;
// scale, shift [C] fp32 -> out [B, C, hp, wp] of y's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int odtk_stem_pool(const void* y, const float* scale,
                              const float* shift, void* out, int dtype, int B,
                              int C, int hc, int wc, int hp, int wp,
                              void* stream) {
  const dim3 grid = grid_for(B * C, hp, wp);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    stem_pool_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(y), scale, shift, static_cast<float*>(out),
        C, hc, wc, hp, wp);
  } else if (dtype == 1) {
    stem_pool_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), scale, shift,
        static_cast<__nv_bfloat16*>(out), C, hc, wc, hp, wp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As odtk_stem_pool, plus idx int8 [B, C, hp, wp] (see stem_pool_idx_kernel).
extern "C" int odtk_stem_pool_idx(const void* y, const float* scale,
                                  const float* shift, void* out, void* idx,
                                  int dtype, int B, int C, int hc, int wc,
                                  int hp, int wp, void* stream) {
  const dim3 grid = grid_for(B * C, hp, wp);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  signed char* ix = static_cast<signed char*>(idx);
  if (dtype == 0) {
    stem_pool_idx_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(y), scale, shift, static_cast<float*>(out),
        ix, C, hc, wc, hp, wp);
  } else if (dtype == 1) {
    stem_pool_idx_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), scale, shift,
        static_cast<__nv_bfloat16*>(out), ix, C, hc, wc, hp, wp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx int8 and g [B, C, hp, wp] (g of y's dtype), scale [C] fp32
// -> dy [B, C, hc, wc] of y's dtype. Returns cudaGetLastError().
extern "C" int odtk_stem_pool_bwd(const void* idx, const void* g,
                                  const float* scale, void* dy, int dtype,
                                  int B, int C, int hc, int wc, int hp, int wp,
                                  void* stream) {
  if (hp != (hc - 1) / 2 + 1 || wp != (wc - 1) / 2 + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = grid_for(B * C, hp, wp);  // one thread per 2x2 quad
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const signed char* ix = static_cast<const signed char*>(idx);
  if (dtype == 0) {
    stem_pool_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        ix, static_cast<const float*>(g), scale, static_cast<float*>(dy), C,
        hc, wc, hp, wp);
  } else if (dtype == 1) {
    stem_pool_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        ix, static_cast<const __nv_bfloat16*>(g), scale,
        static_cast<__nv_bfloat16*>(dy), C, hc, wc, hp, wp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
