// Rotated anchor matcher: for every anchor quad, the best (IoU, target) over
// the targets of its image, by polygon clip (csrc/quad_iou.cuh).
//
// Replaces two TPU kernels, both run by one kernel template:
// - odtk_tpu/ops/pallas/match_rotated_kernel.py:rotated_match_pallas
//   (_match_kernel), the batched matcher of every rotated training step:
//   per image the packed active targets (rows of quad + original slot, the
//   first n_act[b] of them active, in ascending slot order), an AABB skip,
//   a strict '>' fold from (-2, slot 0). Entry odtk_match_rotated, which
//   takes every FPN level of a step in one launch.
// - odtk_tpu/ops/pallas/iou_kernel.py:rotated_best_match_pallas, taken here
//   with the semantics of the JAX jnp form rotated_best_match that it
//   stands for, exactly (kExact): one image, every target row visited in
//   order, an invalid one counting as IoU -1, a strict '>' fold from
//   (-2, 0), index = target row. Entry odtk_rotated_best_match.
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
//   - Windows of 32 target rows: warp 0 stages the window's rows that take
//     part (the active rows; kExact: the valid ones, compacted by a ballot)
//     in shared memory with their axis-aligned boxes and half areas, so
//     the row count is bounded by nothing but the loop, and a window of
//     invalid rows clips nothing. Each thread tests its anchor's box
//     against the staged ones and appends the pairs that can overlap to a
//     compacted list (a warp-aggregated append: one shared atomic a
//     warp); then all 256 threads clip the list, so no lane idles on a
//     skipped pair.
//   - The skip rule: a pair is skipped only when both quads have finite
//     corners below kSkipLimit in magnitude, the target is convex in the
//     clip's orientation (convex_left), and their boxes, each widened by
//     kSkipMargin (well over the 0.001 pad and the clip's rounding at
//     those magnitudes), are disjoint: the clip then ends with no area,
//     inter = +0, and its IoU is 0 / uni, +0.0 where uni > 0 and NaN where
//     both quads have no area (0 / 0). Any other pair is clipped (a
//     non-finite corner, a coordinate beyond the limit, a target of
//     collinear corners, which the clip does not bound).
//   - The fold: several threads clip pairs of one anchor, so each IoU goes
//     into a per-anchor 64-bit shared key by atomicMax on (the IoU's bits
//     mapped to an unsigned order, -0.0 to +0.0 first; ~row): IoU
//     descending, then row ascending, which is the strict '>' fold in row
//     order, deterministic whatever the order of the atomics. NaN never
//     enters (the fold's '>' never takes it). The batched form folds the
//     IoUs >= 0 and leaves an anchor that no clipped pair reached at (-2,
//     slot 0). kExact folds every IoU > -2, and beside the key keeps in
//     registers the first skipped row whose stand-in is +0.0 and, for the
//     block, the first invalid row (-1): the larger of the three keys is
//     the fold's (IoU, row), and (-2, 0) where none exists.
//
// So the batched form equals the plain fold wherever its best IoU is > 0,
// IoU and slot, and both are <= 0 elsewhere (background); kExact equals
// the plain fold everywhere. The plain versions (ops/kernels/
// match_rotated.py) skip nothing.

#include <cuda_runtime.h>

#include <cmath>

#include "quad_iou.cuh"

namespace {

constexpr int kThreads = 256;  // = anchors a tile
constexpr int kChunk = 32;     // target rows a window: a bit each
constexpr int kMaxLevels = 8;
constexpr int kFields = 5;     // int64 fields a level in the host table
// A clip over disjoint boxes ends with count <= 2 vertices (inter 0) unless
// rounding keeps a vertex within a few ulps of both quads; coordinates
// below 2^13 round by < 1e-3 (fp32's spacing there), so a gap of 0.25
// after the 0.001 pad leaves no such vertex (csrc/nms_rotated.cu).
constexpr float kSkipMargin = 0.25f;
constexpr float kSkipLimit = 8192.f;

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

// Whether a quad's corners turn left at each of the four corners (every
// cross product of consecutive edges > 0, rounded as the plain version
// rounds it): a convex quad in the clip's orientation, whose four edge
// half-planes meet in the quad itself. A quad whose corners are collinear
// (a point, a segment, no area) meets them in a line or the plane: a clip
// against it can keep a subject far outside its box.
__device__ __forceinline__ bool convex_left(const float x[4],
                                            const float y[4]) {
  bool left = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = (j + 1) % 4, l = (j + 2) % 4;
    left &= __fsub_rn(__fmul_rn(__fsub_rn(x[k], x[j]), __fsub_rn(y[l], y[k])),
                      __fmul_rn(__fsub_rn(y[k], y[j]),
                                __fsub_rn(x[l], x[k]))) > 0.f;
  }
  return left;
}

// A quad's axis-aligned box widened by kSkipMargin, and whether a pair of
// it may be skipped: its corners finite and below kSkipLimit in magnitude
// and, for a clip quad (a target row), convex_left.
struct Box {
  float lo_x, lo_y, hi_x, hi_y;
  bool skip;
};

__device__ __forceinline__ Box box_of(const float x[4], const float y[4],
                                      bool clip) {
  Box q;
  q.skip = !clip || convex_left(x, y);
  q.lo_x = q.lo_y = INFINITY;
  q.hi_x = q.hi_y = -INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q.skip &= fabsf(x[c]) < kSkipLimit && fabsf(y[c]) < kSkipLimit;
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
  return !(a.skip && t.skip && disjoint);
}

// The fold's key of (IoU v, row): v's bits in an unsigned order (-0.0 as
// +0.0), then ~row, so atomicMax keeps IoU descending, row ascending. v is
// not NaN; every v > -2 gives a key > 0.
__device__ __forceinline__ unsigned long long fold_key(float v, int row) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  const unsigned order = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(order) << 32) |
         ~static_cast<unsigned>(row);
}

__device__ __forceinline__ float fold_value(unsigned long long key) {
  const unsigned order = static_cast<unsigned>(key >> 32);
  return __uint_as_float((order & 0x80000000u) ? (order & 0x7fffffffu)
                                               : ~order);
}

// kExact = false: rows [levels, batch, m, 9] (quad, slot), the first
// n_act[l, b] active; valid unused. kExact = true (one level, batch 1):
// rows [m, 8] (quads), valid [m] (nonzero: valid); n_act unused.
template <bool kExact>
__global__ void __launch_bounds__(kThreads)
    match_kernel(const Table t, const float* __restrict__ rows,
                 const int* __restrict__ n_act,
                 const unsigned char* __restrict__ valid) {
  constexpr int kRowWidth = kExact ? 8 : 9;
  __shared__ float ax[4][kThreads], ay[4][kThreads], ahalf[kThreads];
  __shared__ float tx[4][kChunk], ty[4][kChunk], thalf[kChunk];
  __shared__ Box tbox[kChunk];
  __shared__ int trow[kChunk];                         // the staged rows
  __shared__ unsigned short pairs[kThreads * kChunk];  // anchor << 5 | k
  __shared__ unsigned long long key[kThreads];
  __shared__ int nstaged, npairs, first_invalid;

  Level lv;
  const int b = blockIdx.x % t.batch;  // the images of a tile adjacent
  const int tile = blockIdx.x / t.batch;
  const int l = level_of(t, tile, &lv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = (tile - lv.tile0) * kThreads + tid;
  const bool live = i < lv.n;
  const int count = kExact ? t.m : n_act[l * t.batch + b];
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
  const Box abox = box_of(qx, qy, false);
  const float half = odtk::subject_half_area(qx, qy);
  ahalf[tid] = half;
  key[tid] = 0ull;    // read back by this thread only, after the windows
  int zero_row = -1;  // kExact: the first skipped row standing for +0.0
  if (tid == 0) first_invalid = -1;

  for (int c0 = 0; c0 < count; c0 += kChunk) {  // block-uniform
    if (tid < 32) {
      const int row = c0 + tid;
      const bool in = row < count;
      const bool part = in && (!kExact || valid[row] != 0);
      const unsigned staged = __ballot_sync(0xffffffffu, part);
      if (part) {
        const int k = __popc(staged & ((1u << tid) - 1u));
        float cx[4], cy[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cx[c] = tx[c][k] = r[(long long)row * kRowWidth + 2 * c];
          cy[c] = ty[c][k] = r[(long long)row * kRowWidth + 2 * c + 1];
        }
        tbox[k] = box_of(cx, cy, true);
        thalf[k] = odtk::clip_half_area(cx, cy);
        trow[k] = row;
      }
      const unsigned invalid = __ballot_sync(0xffffffffu, in && !part);
      if (tid == 0) {
        nstaged = __popc(staged);
        npairs = 0;
        if (kExact && first_invalid < 0 && invalid) {
          first_invalid = c0 + __ffs(invalid) - 1;
        }
      }
    }
    __syncthreads();

    const int cn = nstaged;
    if (cn > 0) {  // block-uniform
      // this anchor's staged rows that need a clip, one bit each, appended
      // to the list at the warp's offset
      unsigned hits = 0u;
      if (live) {
        for (int k = 0; k < cn; ++k) {
          if (must_clip(abox, tbox[k])) {
            hits |= 1u << k;
          } else if (kExact && zero_row < 0 &&
                     __fadd_rn(half, thalf[k]) > 0.f) {
            zero_row = trow[k];
          }
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
        const float iou = odtk::quad_iou(sx, sy, cx, cy,
                                         __fadd_rn(ahalf[a], thalf[k]));
        if (kExact ? iou > -2.f : iou >= 0.f) {
          atomicMax(&key[a], fold_key(iou, trow[k]));
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    unsigned long long k = key[tid];
    if (kExact && zero_row >= 0) k = max(k, fold_key(0.f, zero_row));
    if (kExact && first_invalid >= 0) {
      k = max(k, fold_key(-1.f, first_invalid));
    }
    float best = -2.f;
    int slot = 0;
    if (k) {
      best = fold_value(k);
      const int row = static_cast<int>(~static_cast<unsigned>(k));
      slot = kExact ? row : static_cast<int>(r[(long long)row * 9 + 8]);
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
  match_kernel<false><<<tiles * batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, rows, n_act,
                                                             nullptr);
  return static_cast<int>(cudaGetLastError());
}

// anchors [n, 8], clips [m, 8] fp32, valid [m] bytes (nonzero: valid) ->
// best_iou [n] fp32, best_idx [n] int32. All contiguous on the device. One
// block a tile of 256 anchors. Returns cudaGetLastError() after the
// launch.
extern "C" int odtk_rotated_best_match(const float* anchors,
                                       const float* clips,
                                       const unsigned char* valid, int n,
                                       int m, float* best_iou, int* best_idx,
                                       void* stream) {
  if (n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kThreads - 1) / kThreads;
  if (tiles == 0) return 0;
  Table t{};
  t.lv[0] = Level{anchors, best_iou, best_idx, n, 0};
  t.levels = 1;
  t.tiles = tiles;
  t.batch = 1;
  t.m = m;
  match_kernel<true><<<tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, clips,
                                                            nullptr, valid);
  return static_cast<int>(cudaGetLastError());
}
