// Rotated anchor matcher: for every anchor quad, the best (IoU, target) over
// the targets of its image, by polygon clip (csrc/quad_iou.cuh).
//
// Replaces two TPU kernels:
// - odtk_tpu/ops/pallas/match_rotated_kernel.py:rotated_match_pallas
//   (_match_kernel), the batched matcher of every rotated training step:
//   per image the packed active targets (rows of quad + original slot, the
//   first n_act[b] of them active, in ascending slot order), an AABB skip,
//   a strict '>' fold from (-2, slot 0). Entry odtk_match_rotated, which
//   takes every FPN level of a step in one launch.
// - odtk_tpu/ops/pallas/iou_kernel.py:rotated_best_match_pallas, taken here
//   with the semantics of the JAX jnp form rotated_best_match that it
//   stands for: one image, every target visited, an invalid one counting as
//   IoU -1, no skip, index = target row. Entry odtk_rotated_best_match
//   (best_match_kernel, one thread an anchor looping over the rows).
//
// Bound on the card: operations. Each (anchor, target) pair that is
// clipped costs ~276-1000 dependent fp32 operations, against 32 bytes of
// anchor read once and 8 of output written per (image, anchor); so the work
// is the pairs that can overlap. Anchors are anchor-major ([H, W, A]), so a
// tile of 256 consecutive anchors is ~9.5 cells of a row, and most of the
// anchors of a tile that a target touches miss the target; a skip decided
// for the whole tile would clip them all, with lanes diverging on the
// clip's vertex count. The levels of a step share one launch. The design:
//
//   - Grid: one block a (tile of 256 anchors, image), over the tiles of
//     every level (a table of level descriptors passed by value, a tile's
//     level found by its first tile), the images of a tile adjacent so
//     that they find its anchors in L2. The images run in parallel: a
//     block that walked the images in turn put their clip phases in one
//     dependent chain, measured slower on the card than the tile skip's
//     five launches. A block of an image without targets writes (-2, 0)
//     and exits.
//   - Chunks of 32 of the image's active target rows are staged in
//     shared memory with their axis-aligned boxes. Each thread tests its
//     anchor's box against the chunk's and appends the pairs that can
//     overlap to a compacted list (a warp-aggregated append: one shared
//     atomic a warp); then all 256 threads clip the list, so no lane idles
//     on a skipped pair.
//   - The skip rule is csrc/nms_rotated.cu's: a pair is skipped only when
//     both quads are finite and their boxes, each widened by kSkipMargin
//     (well over the 0.001 pad and the clip's rounding), are disjoint; its
//     IoU is then 0 (or NaN for two zero-area quads), never > 0. A
//     non-finite quad is always clipped.
//   - The fold: several threads clip pairs of one anchor, so each IoU >= 0
//     goes into a per-anchor 64-bit shared key by atomicMax on (IoU bits,
//     ~t), t the packed row: IoU descending, then row ascending, which is
//     the strict '>' fold in ascending slot order wherever the best IoU is
//     > 0, deterministic whatever the order of the atomics. An anchor that
//     no clipped pair reached with IoU >= 0 keeps (-2, slot 0).
//
// So wherever the plain fold's best IoU is > 0 the kernel's equals it, IoU
// and slot; elsewhere both are <= 0 (background). The plain version
// (ops/kernels/match_rotated.py) skips nothing.

#include <cuda_runtime.h>

#include <cmath>

#include "quad_iou.cuh"

namespace {

constexpr int kRowWidth = 9;  // 4 corners (x, y), slot or valid flag

// ------------------------------------------------ all levels, one launch
constexpr int kThreads = 256;  // = anchors a tile
constexpr int kChunk = 32;     // target rows staged at once: a bit each
constexpr int kMaxLevels = 8;
constexpr int kFields = 5;     // int64 fields a level in the host table
// A clip over disjoint boxes ends with count <= 2 vertices (inter 0) unless
// rounding keeps a vertex within a few ulps of both quads; coordinates
// below ~1e4 round by < 1e-3, so a gap of 0.25 after the 0.001 pad leaves
// no such vertex (csrc/nms_rotated.cu).
constexpr float kSkipMargin = 0.25f;

struct Level {
  const float* anchors;  // [n, 8]
  float* iou;            // [batch, n]
  int* slot;             // [batch, n]
  int n;
  int tile0;             // the level's first tile
};

struct Table {
  Level lv[kMaxLevels];
  int levels;
  int tiles;
  int batch;
  int m;
};

// The level of a tile (tile0 ascending), by compile-time indices so the
// table stays in the parameter bank.
__device__ __forceinline__ int level_of(const Table& t, int tile, Level* lv) {
  int l = 0;
  *lv = t.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < t.levels && tile >= t.lv[i].tile0) {
      l = i;
      *lv = t.lv[i];
    }
  }
  return l;
}

// A quad's axis-aligned box widened by kSkipMargin, and whether its
// corners are finite.
struct Box {
  float lo_x, lo_y, hi_x, hi_y;
  bool finite;
};

__device__ __forceinline__ Box box_of(const float x[4], const float y[4]) {
  Box q;
  q.finite = true;
  q.lo_x = q.lo_y = INFINITY;
  q.hi_x = q.hi_y = -INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q.finite &= isfinite(x[c]) && isfinite(y[c]);
    q.lo_x = fminf(q.lo_x, x[c]);
    q.hi_x = fmaxf(q.hi_x, x[c]);
    q.lo_y = fminf(q.lo_y, y[c]);
    q.hi_y = fmaxf(q.hi_y, y[c]);
  }
  q.lo_x -= kSkipMargin;
  q.lo_y -= kSkipMargin;
  q.hi_x += kSkipMargin;
  q.hi_y += kSkipMargin;
  return q;
}

__device__ __forceinline__ bool must_clip(const Box& a, const Box& t) {
  const bool disjoint = a.lo_x > t.hi_x || t.lo_x > a.hi_x ||
                        a.lo_y > t.hi_y || t.lo_y > a.hi_y;
  return !(a.finite && t.finite && disjoint);
}

__global__ void __launch_bounds__(kThreads)
    match_levels_kernel(const Table t, const float* __restrict__ rows,
                        const int* __restrict__ n_act) {
  __shared__ float ax[4][kThreads], ay[4][kThreads];
  __shared__ float tx[4][kChunk], ty[4][kChunk];
  __shared__ Box tbox[kChunk];
  __shared__ unsigned short pairs[kThreads * kChunk];  // anchor << 5 | row
  __shared__ unsigned long long key[kThreads];
  __shared__ int npairs;

  Level lv;
  const int b = blockIdx.x % t.batch;  // the images of a tile adjacent
  const int tile = blockIdx.x / t.batch;
  const int l = level_of(t, tile, &lv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = (tile - lv.tile0) * kThreads + tid;
  const bool live = i < lv.n;
  const int count = n_act[l * t.batch + b];
  float* out_iou = lv.iou + (long long)b * lv.n;
  int* out_slot = lv.slot + (long long)b * lv.n;
  if (count == 0) {  // block-uniform
    if (live) {
      out_iou[i] = -2.f;
      out_slot[i] = 0;
    }
    return;
  }
  const float* r = rows + ((long long)l * t.batch + b) * t.m * kRowWidth;
  float qx[4], qy[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    qx[c] = live ? lv.anchors[(long long)i * 8 + 2 * c] : 0.f;
    qy[c] = live ? lv.anchors[(long long)i * 8 + 2 * c + 1] : 0.f;
    ax[c][tid] = qx[c];
    ay[c][tid] = qy[c];
  }
  const Box abox = box_of(qx, qy);
  key[tid] = 0ull;  // read back by this thread only, after the chunks

  for (int c0 = 0; c0 < count; c0 += kChunk) {  // block-uniform
    const int cn = min(kChunk, count - c0);
    if (tid < cn) {
      float cx[4], cy[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        cx[c] = tx[c][tid] = r[(c0 + tid) * kRowWidth + 2 * c];
        cy[c] = ty[c][tid] = r[(c0 + tid) * kRowWidth + 2 * c + 1];
      }
      tbox[tid] = box_of(cx, cy);
    }
    if (tid == 0) npairs = 0;
    __syncthreads();

    // this anchor's rows that need a clip, one bit each, appended to the
    // list at the warp's offset
    unsigned hits = 0u;
    if (live) {
      for (int k = 0; k < cn; ++k) {
        if (must_clip(abox, tbox[k])) hits |= 1u << k;
      }
    }
    const int mine = __popc(hits);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int base = 0;
    if (lane == 31 && incl) base = atomicAdd(&npairs, incl);
    base = __shfl_sync(0xffffffffu, base, 31);
    for (int pos = base + incl - mine; hits; hits &= hits - 1u, ++pos) {
      pairs[pos] = static_cast<unsigned short>((tid << 5) |
                                               (__ffs(hits) - 1));
    }
    __syncthreads();

    const int np = npairs;
    for (int p = tid; p < np; p += kThreads) {
      const int a = pairs[p] >> 5, k = pairs[p] & 31;
      float sx[4], sy[4], cx[4], cy[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sx[c] = ax[c][a];  // the anchor is the subject
        sy[c] = ay[c][a];
        cx[c] = tx[c][k];  // the target the clip quad
        cy[c] = ty[c][k];
      }
      const float iou = odtk::quad_iou(sx, sy, cx, cy);
      if (iou >= 0.f) {  // + 0 makes a -0 +0, below every positive key
        const unsigned bits = __float_as_uint(__fadd_rn(iou, 0.f));
        atomicMax(&key[a], (static_cast<unsigned long long>(bits) << 32) |
                               ~static_cast<unsigned>(c0 + k));
      }
    }
    __syncthreads();
  }
  if (live) {
    const unsigned long long k = key[tid];
    float best = -2.f;
    int slot = 0;
    if (k) {
      best = __uint_as_float(static_cast<unsigned>(k >> 32));
      const unsigned row = ~static_cast<unsigned>(k);
      slot = static_cast<int>(r[(long long)row * kRowWidth + 8]);
    }
    out_iou[i] = best;
    out_slot[i] = slot;
  }
}

// The table from the host array (kFields int64 a level: anchors, iou,
// slot, n, tile0); false if it is not the one the wrapper's level_tiles
// builds for these shapes.
bool make_table(const long long* host, int levels, int tiles, int batch,
                int m, Table* t) {
  if (levels < 1 || levels > kMaxLevels || batch < 0 || m < 0 || tiles < 0 ||
      (long long)tiles * batch >= (1ll << 31)) {
    return false;
  }
  *t = Table{};
  t->levels = levels;
  t->tiles = tiles;
  t->batch = batch;
  t->m = m;
  long long next = 0;
  for (int l = 0; l < levels; ++l) {
    const long long* f = host + (long long)l * kFields;
    Level& lv = t->lv[l];
    lv.anchors = reinterpret_cast<const float*>(f[0]);
    lv.iou = reinterpret_cast<float*>(f[1]);
    lv.slot = reinterpret_cast<int*>(f[2]);
    if (f[3] < 0 || f[3] >= (1ll << 31) || f[4] != next) return false;
    lv.n = static_cast<int>(f[3]);
    lv.tile0 = static_cast<int>(f[4]);
    next += (f[3] + kThreads - 1) / kThreads;
  }
  return next == tiles;
}

// --------------------------------------- one image, every row (row 8)
__global__ void __launch_bounds__(kThreads)
    best_match_kernel(const float* __restrict__ anchors,
                      const float* __restrict__ rows, int n, int m,
                      float* __restrict__ best_iou,
                      int* __restrict__ best_idx) {
  extern __shared__ float srow[];  // [m, 9]
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  for (int k = tid; k < m * kRowWidth; k += kThreads) srow[k] = rows[k];
  __syncthreads();
  if (i >= n) return;
  float ax[4], ay[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = anchors[(long long)i * 8 + 2 * k];
    ay[k] = anchors[(long long)i * 8 + 2 * k + 1];
  }
  float best = -2.f;
  int idx = 0;
  for (int t = 0; t < m; ++t) {
    const float* r = srow + t * kRowWidth;
    const float cx[4] = {r[0], r[2], r[4], r[6]};
    const float cy[4] = {r[1], r[3], r[5], r[7]};
    const float iou = r[8] > 0.f ? odtk::quad_iou(ax, ay, cx, cy) : -1.f;
    if (iou > best) {
      best = iou;
      idx = t;
    }
  }
  best_iou[i] = best;
  best_idx[i] = idx;
}

}  // namespace

// table: kFields int64 a level (anchors [n, 8] fp32, best_iou [batch, n]
// fp32, best_slot [batch, n] int32, n, the level's first tile), `levels`
// levels covering `tiles` tiles of 256 anchors; rows [levels, batch, m, 9]
// fp32 (quad, original slot; the first n_act[l, b] rows of image b active
// at level l), n_act [levels, batch] int32. All on the device and
// contiguous. One block a (tile, image). Returns cudaErrorInvalidValue for
// a table that does not fit the shapes, else cudaGetLastError() after the
// launch.
extern "C" int odtk_match_rotated(const long long* table, int levels,
                                  int tiles, const float* rows,
                                  const int* n_act, int batch, int m,
                                  void* stream) {
  Table t;
  if (!make_table(table, levels, tiles, batch, m, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0 || batch == 0) return 0;
  match_levels_kernel<<<tiles * batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, rows, n_act);
  return static_cast<int>(cudaGetLastError());
}

// anchors [n, 8], rows [m, 9] (quad, valid flag 1 or 0) -> best_iou [n]
// fp32, best_idx [n] int32. All contiguous on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int odtk_rotated_best_match(const float* anchors, const float* rows,
                                       int n, int m, float* best_iou,
                                       int* best_idx, void* stream) {
  const size_t smem = size_t(m) * kRowWidth * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      best_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  best_match_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      anchors, rows, n, m, best_iou, best_idx);
  return static_cast<int>(cudaGetLastError());
}
