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
// The backward is a gather over the conv map: each conv element sums the
// cotangents of the windows whose code points at it, times the scale, and
// is written once, with no atomics. Bound on the card: bytes, the dy write
// plus the codes and cotangent reads; at the train batch's conv1, bf16
// [8, 64, 448, 576], 264 + 33 + 66 MB, 0.1085 ms at 3.35 TB/s (fp32 694 MB,
// 0.2071 ms). Its first form ran a thread per 2x2 quad of conv elements and
// took ~0.212 ms bf16 whether dy was fresh, reused, or written right after
// the forward, and inside a train step, where the cotangent arrives NCHW
// contiguous (no copy before it): each warp store of a conv row covered
// 128 bytes at half density in 2-byte stores, each window's code and
// cotangent were read by up to four threads in scalar loads, and a quarter
// of the threads idled at a pooled width of 288. The design:
//   - A thread takes the forward's column groups: 4 pooled columns (conv
//     columns 8g .. 8g+7) of one pooled row p of one plane. It loads a
//     window row's 4 codes as one 32-bit word and its 4 cotangents as one
//     8- (bf16) or 16-byte (fp32) word, scalar loads where the pooled width
//     is not a multiple of 4 or a base is off the grid; window 4g+4, which
//     conv column 8g+7 also lies in, comes from the next lane by a shuffle
//     (a warp's last lane loads it itself).
//   - Conv row 2p lies only in window row p and 2p+1 in rows p and p+1, so
//     the thread loads window rows p and p+1 and writes conv rows 2p and
//     2p+1. Row p+1 is loaded again by row p+1's thread, an L2 hit. Walks
//     down strips of 2-16 pooled rows, carrying row p+1 as the next p,
//     measured slower: the compiler hoists a strip's loads, which raises
//     the registers (32 at 1 row, 62 at 4, 80 at 8 in bf16) and cuts the
//     warps an SM keeps.
//   - A conv row's 8 columns go out as one 16-byte store in bf16, so a
//     warp writes 512 contiguous bytes a row, scalar stores where the row
//     or the base is not 16-byte aligned or the group passes the row's
//     end. In fp32 a lane's 32 bytes as two direct stores leave each store
//     instruction's 1 KB span half written, and the kernel ran barely
//     under the first form (~0.267 ms against ~0.270); there the lanes
//     stage their rows in shared memory and each run of lanes that write
//     one row contiguously goes out as one TMA bulk copy (~0.236 ms).
//     Staged bf16 measured 22% slower than direct.
// Measured so: ~0.128 ms bf16 (85% of the bound) and ~0.236 ms fp32
// (88%), where writing dy alone (dy.zero_()) takes ~0.081 and ~0.161.

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

// Both directions run a thread per (plane, strip, column group), threads
// in that order from the fastest: group, strip, plane; blocks of kThreads.
// A forward strip is kStripRows pooled rows, a backward strip one.
constexpr int kThreads = 128;
constexpr int kStripRows = 8;    // pooled rows of a forward strip
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
__global__ void __launch_bounds__(kThreads)
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
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
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

// One window row of a group as loaded: the codes of windows 4g .. 4g+3
// (byte j: window 4g + j; 9 where absent), their cotangents (0 where
// absent), and window 4g+4's where this lane takes it itself.
template <typename T>
struct WinRow {
  unsigned codes;
  Quad<T> g;
  int code4;
  T g4;
};

// The same row unpacked: codes and fp32 cotangents of windows 4g .. 4g+4.
struct Windows {
  int c[kGroupCols + 1];
  float v[kGroupCols + 1];
};

// The 8 conv columns 8g .. 8g+7 of one conv row, for one or two 16-byte
// stores.
template <typename T>
struct alignas(16) Octet {
  T e[2 * kGroupCols];
};

template <typename T>
__device__ __forceinline__ Quad<T> load_quad(const T* p) {
  Quad<T> q;
  if constexpr (sizeof(Quad<T>) == 8) {
    *reinterpret_cast<uint2*>(&q) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    *reinterpret_cast<uint4*>(&q) = __ldg(reinterpret_cast<const uint4*>(p));
  }
  return q;
}

// Window row r of a group (q0 = 4g): one 32-bit load of the codes and one
// 8- or 16-byte load of the cotangents where vec (the pooled width a
// multiple of 4, both bases aligned), scalar loads otherwise; window
// q0 + 4 too where own_right.
template <typename T>
__device__ __forceinline__ void load_window_row(const signed char* ip,
                                                const T* gp, int r, bool live,
                                                int q0, int wp, bool vec,
                                                bool own_right, WinRow<T>& w) {
  w.codes = 0x09090909u;
  w.code4 = 9;
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) w.g.e[j] = from_float<T>(0.f);
  w.g4 = from_float<T>(0.f);
  if (!live) return;
  const size_t o = (size_t)r * wp + q0;
  if (vec) {
    w.codes = __ldg(reinterpret_cast<const unsigned*>(ip + o));
    w.g = load_quad(gp + o);
  } else {
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < kGroupCols; ++j) {
      if (q0 + j < wp) {
        c |= (unsigned)(unsigned char)ip[o + j] << (8 * j);
        w.g.e[j] = gp[o + j];
      } else {
        c |= 9u << (8 * j);
      }
    }
    w.codes = c;
  }
  if (own_right && q0 + kGroupCols < wp) {
    w.code4 = ip[o + kGroupCols];
    w.g4 = gp[o + kGroupCols];
  }
}

// Unpacks a loaded row; window 4g+4 is the next lane's window 4(g+1),
// passed by a warp shuffle, save where this lane took it itself (a warp's
// last lane) and in the plane's last group, where it lies past the row's
// end. Every lane of the warp calls it together (the shuffle).
template <typename T>
__device__ __forceinline__ Windows unpack(const WinRow<T>& w, bool own_right,
                                          bool last_group) {
  Windows u;
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) {
    u.c[j] = (int)((w.codes >> (8 * j)) & 0xffu);
    u.v[j] = to_float(w.g.e[j]);
  }
  int c4 = __shfl_down_sync(kFullMask, u.c[0], 1);
  float v4 = __shfl_down_sync(kFullMask, u.v[0], 1);
  if (own_right) {
    c4 = w.code4;
    v4 = to_float(w.g4);
  }
  if (last_group) {
    c4 = 9;
    v4 = 0.f;
  }
  u.c[kGroupCols] = c4;
  u.v[kGroupCols] = v4;
  return u;
}

// Conv rows 2p (top) and 2p+1 (bot), columns 8g .. 8g+7, from window rows
// p (a) and p+1 (b). Conv row 2p lies only in window row p, 2p+1 in rows p
// and p+1; conv column 2q only in window column q, 2q+1 in q and q+1. A
// window routes to the conv element at row offset dr, column offset dc
// (0..2 from its top-left, row 2p'-1, column 2q'-1) when its code is
// 3 dr + dc. Each sum is taken in fp32 in the order of ascending p', then
// q' (max_pool2d's own backward's), then scaled once.
__device__ __forceinline__ void route(const Windows& a, const Windows& b,
                                      float sc, float top[2 * kGroupCols],
                                      float bot[2 * kGroupCols]) {
#pragma unroll
  for (int j = 0; j < kGroupCols; ++j) {
    float acc = 0.f;
    if (a.c[j] == 4) acc += a.v[j];
    top[2 * j] = __fmul_rn(acc, sc);
    acc = 0.f;
    if (a.c[j] == 5) acc += a.v[j];
    if (a.c[j + 1] == 3) acc += a.v[j + 1];
    top[2 * j + 1] = __fmul_rn(acc, sc);
    acc = 0.f;
    if (a.c[j] == 7) acc += a.v[j];
    if (b.c[j] == 1) acc += b.v[j];
    bot[2 * j] = __fmul_rn(acc, sc);
    acc = 0.f;
    if (a.c[j] == 8) acc += a.v[j];
    if (a.c[j + 1] == 6) acc += a.v[j + 1];
    if (b.c[j] == 2) acc += b.v[j];
    if (b.c[j + 1] == 0) acc += b.v[j + 1];
    bot[2 * j + 1] = __fmul_rn(acc, sc);
  }
}

template <typename T>
__device__ __forceinline__ Octet<T> to_octet(const float v[2 * kGroupCols]) {
  Octet<T> o;
#pragma unroll
  for (int e = 0; e < 2 * kGroupCols; ++e) o.e[e] = from_float<T>(v[e]);
  return o;
}

// One conv row's 8 columns from registers: 16-byte stores where vec (the
// whole group inside the row, the row and the base 16-byte aligned),
// scalar stores otherwise.
template <typename T>
__device__ __forceinline__ void store_row(T* row, int col0, int wc, bool vec,
                                          const float v[2 * kGroupCols]) {
  const Octet<T> o = to_octet<T>(v);
  if (vec) {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(o) / 16); ++k)
      reinterpret_cast<uint4*>(row + col0)[k] =
          reinterpret_cast<const uint4*>(o.e)[k];
  } else {
#pragma unroll
    for (int e = 0; e < 2 * kGroupCols; ++e)
      if (col0 + e < wc) row[col0 + e] = o.e[e];
  }
}

// The staged store (fp32): each lane puts its 8 columns in shared memory,
// and the first lane of each run of lanes that write one conv row
// contiguously (consecutive groups of one row) copies the run out with one
// TMA bulk store. Every lane of the warp calls it together, once for each
// buffer.
template <typename T>
__device__ __forceinline__ void stage_row(uint4* stage, T* row, bool live,
                                          int col0, int wc, bool vec,
                                          unsigned g,
                                          const float v[2 * kGroupCols]) {
  constexpr int kWords = (int)(sizeof(Octet<T>) / 16);
  const unsigned lane = threadIdx.x & 31;
  const bool bulk = live && vec;
  const Octet<T> o = to_octet<T>(v);
  uint4* mine = stage + threadIdx.x * kWords;
  if (bulk) {
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      mine[k] = reinterpret_cast<const uint4*>(o.e)[k];
  } else if (live) {
    store_row(row, col0, wc, false, v);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  const unsigned vecs = __ballot_sync(kFullMask, bulk);
  const unsigned starts =
      __ballot_sync(kFullMask, bulk && (lane == 0 || g == 0));
  if ((starts >> lane) & 1u) {
    const unsigned stop =
        lane == 31 ? 0u : (starts | ~vecs) & (~0u << (lane + 1));
    const unsigned end = stop ? (unsigned)__ffs(stop) - 1 : 32u;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            row + col0),
        "r"((unsigned)__cvta_generic_to_shared(mine)),
        "r"((end - lane) * kWords * 16)
        : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Row 4 of the kernel table, the gather
//   dy[b, c, i, j] = scale[c] * sum of g[b, c, p', q'] over the windows
//                    (p', q') that hold (i, j) and whose idx points at it
// (see route). A thread owns pooled row p, columns 4g .. 4g+3, of one plane:
// it loads window rows p and p+1 and writes conv rows 2p and 2p+1, columns
// 8g .. 8g+7, so each conv element once: bf16 straight from registers,
// fp32 by stage_row. vec_in: idx and g allow the 32-bit and 8/16-byte
// loads of a window row; vec_out: dy and its rows are 16-byte aligned. No
// atomics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_pool_bwd_kernel(const signed char* __restrict__ idx,
                         const T* __restrict__ g,
                         const float* __restrict__ scale, T* __restrict__ dy,
                         int C, int hc, int wc, int hp, int wp,
                         unsigned planes, unsigned rows, unsigned groups,
                         bool vec_in, bool vec_out) {
  constexpr bool kStaged = sizeof(T) == 4;
  constexpr int kWords = (int)(sizeof(Octet<T>) / 16);
  __shared__ uint4 stage[kStaged ? 2 : 1][kStaged ? kThreads * kWords : 1];
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned gi = tid % groups;
  const unsigned rest = tid / groups;
  const unsigned t = rest / rows;       // plane b * C + c
  const int p = (int)(rest % rows);
  const bool live = t < planes;
  const bool own_right = (threadIdx.x & 31) == 31;
  const bool last_group = gi + 1 == groups;
  const int q0 = kGroupCols * (int)gi;
  const int col0 = 2 * q0;
  const bool vec = vec_out && col0 + 2 * kGroupCols <= wc;
  const size_t plane = live ? t : 0;
  const signed char* ip = idx + plane * hp * wp;
  const T* gp = g + plane * hp * wp;
  const float sc = live ? scale[t % (unsigned)C] : 0.f;

  WinRow<T> a, b;
  load_window_row(ip, gp, p, live, q0, wp, vec_in, own_right, a);
  load_window_row(ip, gp, p + 1, live && p + 1 < hp, q0, wp, vec_in,
                  own_right, b);
  float top[2 * kGroupCols], bot[2 * kGroupCols];
  route(unpack(a, own_right, last_group), unpack(b, own_right, last_group),
        sc, top, bot);
  T* row = dy + (plane * hc + 2 * p) * wc;
  if constexpr (kStaged) {
    stage_row(stage[0], row, live, col0, wc, vec, gi, top);
    stage_row(stage[1], row + wc, live && 2 * p + 1 < hc, col0, wc, vec, gi,
              bot);
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  } else if (live) {
    store_row(row, col0, wc, vec, top);
    if (2 * p + 1 < hc) store_row(row + wc, col0, wc, vec, bot);
  }
}

// The launch of strips of ``rows`` pooled rows: ok false
// when a dimension is out of range (the caller then reports
// cudaErrorInvalidValue).
struct StripGrid {
  bool ok;
  unsigned blocks, planes, strips, groups;
};

StripGrid strip_grid(int B, int C, int hc, int wc, int hp, int wp,
                     int rows) {
  StripGrid f{false, 0, 0, 0, 0};
  if (B <= 0 || C <= 0 || hc <= 0 || wc <= 0 ||
      hp != (hc - 1) / 2 + 1 || wp != (wc - 1) / 2 + 1) {
    return f;
  }
  const long long planes = (long long)B * C;
  const long long strips = (hp + rows - 1) / rows;
  const long long groups = (wp + kGroupCols - 1) / kGroupCols;
  const long long blocks =
      (planes * strips * groups + kThreads - 1) / kThreads;
  if (blocks * kThreads > 0xffffffffLL) return f;   // 32-bit thread ids
  f = StripGrid{true, (unsigned)blocks, (unsigned)planes, (unsigned)strips,
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
  const StripGrid f = strip_grid(B, C, hc, wc, hp, wp, kStripRows);
  if (!f.ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = aligned(y, 16) && (wc * sizeof(T)) % 16 == 0;
  const bool vec_out = wp % kGroupCols == 0 &&
                       aligned(out, kGroupCols * sizeof(T)) &&
                       (!kIdx || aligned(idx, kGroupCols));
  stem_pool_fwd_kernel<T, kIdx>
      <<<f.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(y), scale, shift, static_cast<T*>(out),
          static_cast<signed char*>(idx), C, hc, wc, hp, wp, f.planes,
          f.strips, f.groups, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* idx, const void* g, const float* scale, void* dy,
               int B, int C, int hc, int wc, int hp, int wp, void* stream) {
  const StripGrid f = strip_grid(B, C, hc, wc, hp, wp, 1);
  if (!f.ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = wp % kGroupCols == 0 && aligned(idx, kGroupCols) &&
                      aligned(g, kGroupCols * sizeof(T));
  const bool vec_out = aligned(dy, 16) && (wc * sizeof(T)) % 16 == 0;
  stem_pool_bwd_kernel<T>
      <<<f.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const signed char*>(idx), static_cast<const T*>(g),
          scale, static_cast<T*>(dy), C, hc, wc, hp, wp, f.planes, f.strips,
          f.groups, vec_in, vec_out);
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
  if (dtype == 0) {
    return launch_bwd<float>(idx, g, scale, dy, B, C, hc, wc, hp, wp, stream);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(idx, g, scale, dy, B, C, hc, wc, hp, wp,
                                     stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
