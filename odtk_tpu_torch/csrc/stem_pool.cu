// ResNet stem tail: folded BN affine -> ReLU -> 3x3 / stride 2 / pad 1 max
// pool, in one pass over the stem conv's output, and its gradient.
//
// Replaces the three kernels of the TPU op odtk_tpu/ops/pallas/
// stem_kernel.py:fused_bn_relu_pool: the primal forward (_fwd_kernel,
// stem_pool_fwd_kernel<T, false> below), the forward that also saves the
// window argmax under autodiff (_fwd_idx_kernel, stem_pool_fwd_kernel<T,
// true>) and the backward (_bwd_kernel, stem_pool_bwd_kernel). They compute
// what those kernels compute, not their layout: the input is the plain NCHW
// conv1 output [B, C, Hc, Wc], not the TPU's merged even/odd-column phase
// layout.
//
//   out[b, c, p, q] = max over rows 2p-1..2p+1, cols 2q-1..2q+1 of
//                     relu(y[b, c, row, col] * scale[c] + shift[c])
//
// with padding counted as -inf (every window holds at least one real
// element). The affine runs in fp32 as a rounded multiply then a rounded add
// (no FMA contraction), the maximum is taken in fp32 and rounded once to the
// output type, so the result equals
// max_pool2d(relu(y.float() * scale + shift), 3, 2, 1).to(y.dtype) bit for
// bit. NaN is carried as max_pool2d and the JAX kernels carry it: a window
// that holds a NaN pools to NaN (and its code is 9, below); every max is
// PTX's max.NaN, never fmaxf, which returns the other operand.
//
// Bound on the card: memory bandwidth. The forward reads the conv map once
// and writes the pooled quarter (plus a one-byte code per output with the
// argmax), ~4 operations an input element, far below the H100's flop/byte
// balance; at the path's shapes that is 82.6 MB (bf16 [2, 64, 448, 576]) to
// 363 MB (bf16 [8, ...] with the codes), 25-108 us at 3.35 TB/s. The
// forward's design is for that:
//   - A thread owns a strip: 4 adjacent pooled columns (conv columns 8g-1 ..
//     8g+7) of kStripRows pooled rows of one plane. It walks the strip down,
//     loading each conv row's 8 columns once as 16-byte words (bf16 one,
//     fp32 two; scalar loads where the row or the base is not 16-byte
//     aligned or the group passes the row's end), and keeps the shared row
//     2p+1 of window row p as row 2(p+1)-1 of the next, so a conv element
//     enters the SM once, save the strip's top halo row (1 in 2 * kStripRows
//     + 1, an L2 hit: the strip above read it). Consecutive threads take
//     consecutive groups of one strip, so a warp's loads of a row are one
//     contiguous 512-byte (bf16) span.
//   - The affine and ReLU run once per loaded element. The window's left
//     column 8g-1 is the neighbouring thread's last element, passed after
//     the affine by a warp shuffle; only a warp's first lane (and the
//     plane's first group, which pads) takes it itself.
//   - The conv rows of the next window rows are in flight while one is
//     reduced (a ring of 3 window rows for bf16, 2 for fp32: 64 bytes a
//     thread either way), with 5-7 blocks of 128 resident an SM (72-91
//     registers a thread), so each SM keeps 40-56 KB in flight, more than
//     the ~20 KB that 3.35 TB/s over a ~0.8 us latency needs.
//   - The first maximum is taken in two passes, as the JAX _fwd_idx_kernel
//     does: per conv row the max over columns (2q-1, 2q, 2q+1) and the first
//     column that reaches it, then the first of the three rows that reaches
//     the window max. That is the row-major first max that max_pool2d keeps,
//     ties included.
//   - The 4 outputs of a row go out as one 8-byte (bf16) or 16-byte (fp32)
//     store and the 4 codes as one 32-bit store where the pooled width is a
//     multiple of 4; scalar stores otherwise.
// The backward is a gather over the conv map (one thread per 2x2 quad,
// reading the four windows that hold it), so every element is written once,
// with no atomics and no data-dependent loads; its bytes are the dy write
// plus the idx and g reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// Launch shape of the backward: one thread per 2x2 quad of conv elements,
// x over the pooled columns, y over the pooled rows, z over the B*C planes,
// so a thread's coordinates come from its block and thread indices without
// a 64-bit division.
constexpr int kThreads = 128;

__host__ __device__ inline unsigned col_blocks(int width) {
  return (unsigned)((width + kThreads - 1) / kThreads);
}

// The forward: a thread per (plane, strip, column group), threads in that
// order from the fastest: group, strip, plane.
constexpr int kFwdThreads = 128;
constexpr int kStripRows = 8;    // pooled rows of a strip
constexpr int kGroupCols = 4;    // pooled columns of a group
constexpr unsigned kFullMask = 0xffffffffu;

// max(a, b), NaN if either is NaN (PTX max.NaN, sm_80 and later); fmaxf
// would return the other operand
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float bn_relu(float v, float sc, float sh) {
  return max_nan(__fadd_rn(__fmul_rn(v, sc), sh), 0.f);
}

// The 8 conv columns 8g .. 8g+7 of one row, as loaded, and column 8g-1
// where this thread takes it itself.
template <typename T>
struct alignas(16) Chunk {
  T e[2 * kGroupCols];
  T left;
};

// The 4 outputs of one group's row, for one store.
template <typename T>
struct alignas(kGroupCols * sizeof(T)) Quad {
  T e[kGroupCols];
};

template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int col0, int wc,
                                           bool vec, bool own_left,
                                           Chunk<T>& c) {
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(row + col0);
    uint4* dst = reinterpret_cast<uint4*>(c.e);
#pragma unroll
    for (int k = 0; k < (int)(sizeof(c.e) / 16); ++k) dst[k] = __ldg(src + k);
  } else {
#pragma unroll
    for (int e = 0; e < 2 * kGroupCols; ++e)
      c.e[e] = col0 + e < wc ? row[col0 + e] : from_float<T>(0.f);
  }
  if (own_left && col0 > 0) c.left = row[col0 - 1];
}

// Pass 1 over one conv row of a group: for pooled column j, the max m[j] of
// the post-ReLU values at conv columns 2q-1, 2q, 2q+1 (q = 4g + j) and, with
// kIdx, the first k[j] of the three (0, 1, 2) that reaches it (no matter
// which where m[j] is NaN: the window's code is then 9). Out-of-range rows
// and columns are -inf. own_left: this thread takes column 8g-1 itself
// (c.left, or the pad when g == 0) instead of from the lane below. Every
// lane of the warp calls it together (the shuffle).
template <typename T, bool kIdx>
__device__ __forceinline__ void row_max(const Chunk<T>& c, bool live,
                                        int ncols, bool pad_left,
                                        bool own_left, float sc, float sh,
                                        float m[kGroupCols],
                                        int k[kGroupCols]) {
  float v[2 * kGroupCols];
#pragma unroll
  for (int e = 0; e < 2 * kGroupCols; ++e)
    v[e] = bn_relu(to_float(c.e[e]), sc, sh);
  if (!live || ncols < 2 * kGroupCols) {
#pragma unroll
    for (int e = 0; e < 2 * kGroupCols; ++e)
      if (!live || e >= ncols) v[e] = -INFINITY;
  }
  float l = __shfl_up_sync(kFullMask, v[2 * kGroupCols - 1], 1);
  if (own_left)
    l = live && !pad_left ? bn_relu(to_float(c.left), sc, sh) : -INFINITY;
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) {
    const float a = j ? v[2 * j - 1] : l;
    m[j] = max_nan(max_nan(a, v[2 * j]), v[2 * j + 1]);
    if constexpr (kIdx) k[j] = a >= m[j] ? 0 : v[2 * j] >= m[j] ? 1 : 2;
  }
}

// Rows 2 and 3 of the kernel table: out, and with kIdx the codes idx[o], each
// window's first maximum as a candidate code 0..8, row-major over (rows 2p-1,
// 2p, 2p+1) x (cols 2q-1, 2q, 2q+1), the order in which torch's max_pool2d
// keeps its first max; 9 where the window max is not > 0 (0: the ReLU kills
// the window's gradient; NaN), the code that routes no gradient. Pad
// positions are never candidates. vec_in: y and its rows are 16-byte
// aligned; vec_out: out, idx and the pooled rows allow the 4-wide stores.
template <typename T, bool kIdx>
__global__ void __launch_bounds__(kFwdThreads)
    stem_pool_fwd_kernel(const T* __restrict__ y,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ out,
                         signed char* __restrict__ idx, int C, int hc, int wc,
                         int hp, int wp, unsigned planes, unsigned strips,
                         unsigned groups, bool vec_in, bool vec_out) {
  // window rows whose two conv rows are loaded or in flight: the one being
  // reduced and the next kSlots - 1 (16-byte rows, bf16, need the deeper
  // ring to keep as many bytes in flight as fp32's two words)
  constexpr int kSlots = sizeof(T) == 2 ? 3 : 2;
  const unsigned tid = blockIdx.x * kFwdThreads + threadIdx.x;
  const unsigned g = tid % groups;
  const unsigned rest = tid / groups;
  const unsigned t = rest / strips;     // plane b * C + c
  const int p0 = (int)(rest % strips) * kStripRows;
  const bool live = t < planes;
  // the lane below holds group g - 1 of this strip, unless this is a warp's
  // first lane or the plane's first group
  const bool own_left = (threadIdx.x & 31) == 0 || g == 0;
  const int col0 = 2 * kGroupCols * (int)g;
  const int ncols = wc - col0;
  const bool vec = vec_in && ncols >= 2 * kGroupCols;
  const T* plane = y + (size_t)(live ? t : 0) * hc * wc;
  const float sc = live ? scale[t % (unsigned)C] : 0.f;
  const float sh = live ? shift[t % (unsigned)C] : 0.f;

  auto row_live = [&](int r) { return live && r >= 0 && r < hc; };
  auto load = [&](int r, Chunk<T>& c) {
    if (row_live(r))
      load_chunk(plane + (size_t)r * wc, col0, wc, vec, own_left, c);
  };

  Chunk<T> top, ring[kSlots][2];
  load(2 * p0 - 1, top);
#pragma unroll
  for (int a = 0; a < kSlots; ++a) {
    load(2 * (p0 + a), ring[a][0]);
    load(2 * (p0 + a) + 1, ring[a][1]);
  }
  float mt[kGroupCols], mm[kGroupCols], mb[kGroupCols];
  int kt[kGroupCols], km[kGroupCols], kb[kGroupCols];
  row_max<T, kIdx>(top, row_live(2 * p0 - 1), ncols, g == 0, own_left, sc,
                   sh, mt, kt);
#pragma unroll
  for (int i = 0; i < kStripRows; ++i) {
    const int p = p0 + i;
    row_max<T, kIdx>(ring[i % kSlots][0], row_live(2 * p), ncols, g == 0,
                     own_left, sc, sh, mm, km);
    row_max<T, kIdx>(ring[i % kSlots][1], row_live(2 * p + 1), ncols, g == 0,
                     own_left, sc, sh, mb, kb);
    if (i + kSlots < kStripRows) {      // refill the slot: window p + kSlots
      load(2 * (p + kSlots), ring[i % kSlots][0]);
      load(2 * (p + kSlots) + 1, ring[i % kSlots][1]);
    }
    if (live && p < hp) {
      // pass 2: the first of the rows 2p-1, 2p, 2p+1 that reaches the max
      Quad<T> res;
      unsigned codes = 0;
#pragma unroll
      for (int j = 0; j < kGroupCols; ++j) {
        const float m = max_nan(max_nan(mt[j], mm[j]), mb[j]);
        res.e[j] = from_float<T>(m);
        if constexpr (kIdx) {
          const int code = mt[j] >= m   ? kt[j]
                           : mm[j] >= m ? 3 + km[j]
                                        : 6 + kb[j];
          codes |= (unsigned)(m > 0.f ? code : 9) << (8 * j);
        }
      }
      const int q0 = kGroupCols * (int)g;
      const size_t o = ((size_t)t * hp + p) * wp + q0;
      if (vec_out && q0 + kGroupCols <= wp) {
        *reinterpret_cast<Quad<T>*>(out + o) = res;
        if constexpr (kIdx) *reinterpret_cast<unsigned*>(idx + o) = codes;
      } else {
#pragma unroll
        for (int j = 0; j < kGroupCols; ++j) {
          if (q0 + j < wp) {
            out[o + j] = res.e[j];
            if constexpr (kIdx) idx[o + j] = (signed char)(codes >> (8 * j));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroupCols; ++j) {
      mt[j] = mb[j];
      kt[j] = kb[j];
    }
  }
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

// The forward's launch: ok false when a dimension is out of range (the
// caller then reports cudaErrorInvalidValue).
struct FwdGrid {
  bool ok;
  unsigned blocks, planes, strips, groups;
};

FwdGrid fwd_grid(int B, int C, int hc, int wc, int hp, int wp) {
  FwdGrid f{false, 0, 0, 0, 0};
  if (B <= 0 || C <= 0 || hc <= 0 || wc <= 0 ||
      hp != (hc - 1) / 2 + 1 || wp != (wc - 1) / 2 + 1) {
    return f;
  }
  const long long planes = (long long)B * C;
  const long long strips = (hp + kStripRows - 1) / kStripRows;
  const long long groups = (wp + kGroupCols - 1) / kGroupCols;
  const long long blocks =
      (planes * strips * groups + kFwdThreads - 1) / kFwdThreads;
  if (blocks * kFwdThreads > 0xffffffffLL) return f;   // 32-bit thread ids
  f = FwdGrid{true, (unsigned)blocks, (unsigned)planes, (unsigned)strips,
              (unsigned)groups};
  return f;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, bool kIdx>
int launch_fwd(const void* y, const float* scale, const float* shift,
               void* out, void* idx, int B, int C, int hc, int wc, int hp,
               int wp, void* stream) {
  const FwdGrid f = fwd_grid(B, C, hc, wc, hp, wp);
  if (!f.ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = aligned(y, 16) && (wc * sizeof(T)) % 16 == 0;
  const bool vec_out = wp % kGroupCols == 0 &&
                       aligned(out, kGroupCols * sizeof(T)) &&
                       (!kIdx || aligned(idx, kGroupCols));
  stem_pool_fwd_kernel<T, kIdx>
      <<<f.blocks, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(y), scale, shift, static_cast<T*>(out),
          static_cast<signed char*>(idx), C, hc, wc, hp, wp, f.planes,
          f.strips, f.groups, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [B, C, hc, wc] contiguous on the device, dtype 0 = fp32, 1 = bf16;
// scale, shift [C] fp32 -> out [B, C, hp, wp] of y's dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int odtk_stem_pool(const void* y, const float* scale,
                              const float* shift, void* out, int dtype, int B,
                              int C, int hc, int wc, int hp, int wp,
                              void* stream) {
  if (dtype == 0) {
    return launch_fwd<float, false>(y, scale, shift, out, nullptr, B, C, hc,
                                    wc, hp, wp, stream);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16, false>(y, scale, shift, out, nullptr, B,
                                            C, hc, wc, hp, wp, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As odtk_stem_pool, plus idx int8 [B, C, hp, wp] (see stem_pool_fwd_kernel).
extern "C" int odtk_stem_pool_idx(const void* y, const float* scale,
                                  const float* shift, void* out, void* idx,
                                  int dtype, int B, int C, int hc, int wc,
                                  int hp, int wp, void* stream) {
  if (dtype == 0) {
    return launch_fwd<float, true>(y, scale, shift, out, idx, B, C, hc, wc,
                                   hp, wp, stream);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16, true>(y, scale, shift, out, idx, B, C,
                                           hc, wc, hp, wp, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
