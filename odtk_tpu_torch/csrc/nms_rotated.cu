// Greedy class-aware NMS over rotated boxes as a parallel suppression
// bitmask: rank, mask, scan, four launches and a memset on the caller's
// stream.
//
// Replaces the TPU kernel
// odtk_tpu/ops/pallas/nms_rotated_kernel.py:nms_rotated_pallas (body
// _rot_nms_kernel). Contract: D rounds of masked argmax (lowest index on
// ties) -> record the winner's score, (x1, y1, x2, y2, sin, cos) box and
// class -> zero every live candidate of the same class whose polygon IoU
// against the winner's quad exceeds the threshold, and the winner itself.
// The candidate is the subject of the clip and the winner the clip quad,
// with the +0.001 coincident-coordinate pad (csrc/quad_iou.cuh). A round
// records only when its maximum is > 0; the output is zero-padded and
// score-descending. The corner quads are computed in the kernel as the
// plain version's sincos_box_corners computes them, bit for bit.
//
// The rounds are a scan: in the order (score descending, index ascending)
// over the live candidates (score > 0), a candidate is kept unless an
// earlier kept one of its class suppresses it, and the scan stops at D kept.
//
// Bound on the card: operations, the clips. The inputs are N*(4+24+4)
// bytes an image (64 KB at N = 2000), read once; the work is one polygon
// clip (~276-1000 dependent fp32 operations) per same-class pair that can
// overlap. The round loop of one block per image that this file held before
// ran those clips 100 rounds deep on two SMs of 132. The design takes the
// clips out of the dependent chain:
//
//   1. rank, two launches (grid: candidate blocks x spans of 256 x
//      images, then candidate blocks x images): each live candidate counts
//      the live candidates that precede it in the scan order, a span per
//      block, the spans' counts summed in integer atomics (exact and
//      deterministic, no sort); then it writes itself to order[rank].
//   2. mask (grid: 64 x 64 tiles of ranks, upper triangle, x images):
//      bit (i, j) of the image's [N, ceil(N/64)] 64-bit mask, i ranked
//      before j, is set iff cls[i] == cls[j] and quad_iou(subject j, clip
//      i) > thr. A tile's block first lists the pairs that need a clip,
//      then clips the list with all 256 threads, so a warp does not idle
//      on the lanes whose pair was skipped or of another class. A clip is
//      skipped only where its answer is provably <= thr: both quads
//      finite and their axis-aligned boxes, widened by kSkipMargin (well
//      over the 0.001 pad and the rounding of the clip), disjoint, and
//      thr >= 0. A non-finite quad is always clipped (quad_iou's NaN rule
//      gives 1.0 when both intersection and union are NaN). Tiles past the
//      image's live count exit at once.
//   3. scan (one warp per image): a `removed` bitset of the ranks in shared
//      memory; the warp jumps to the next unremoved rank with
//      __ballot_sync / __ffs over 32 words at a time, notes it, and ORs
//      its mask row into `removed`; it stops at D kept or at the end. Its
//      cost is ~D steps of one mask-row load each, not N; the outputs are
//      gathered from the noted ranks after the loop, all lanes at once.
//      (Loading the rows of the next 8 open ranks at once measured slower
//      on the real candidates: most of the 8 are removed by the first.)
//
// Scratch, one allocation by the wrapper: the mask, batch * N * ceil(N/64)
// * 8 bytes (512 KB an image at N = 2000, 32 MB at 16384), the ranks, the
// live counts, the order and the noted ranks.

#include <cuda_runtime.h>

#include <cmath>

#include "quad_iou.cuh"

namespace {

constexpr int kMaxCandidates = 16384;  // 256 mask words in the scan's smem
constexpr int kRankThreads = 128;
constexpr int kRankSpan = 256;         // preceding candidates a block counts
constexpr int kTile = 64;              // ranks per mask word
constexpr int kMaskThreads = 256;
constexpr int kMaxWords = kMaxCandidates / kTile;
// A clip over disjoint boxes ends with count <= 2 vertices (inter 0) unless
// rounding keeps a vertex within a few ulps of both quads; coordinates
// below ~1e4 round by < 1e-3, so a gap of 0.25 after the 0.001 pad leaves
// no such vertex.
constexpr float kSkipMargin = 0.25f;

// rank[j] += the live candidates i in this block's span of kRankSpan that
// precede j in the scan order (higher score, or equal and lower index); the
// spans' partial counts meet in integer atomics, so the rank is exact. The
// blocks of the first span also count the live candidates.
__global__ void __launch_bounds__(kRankThreads)
    nms_count_kernel(const float* __restrict__ scores, int n,
                     int* __restrict__ rank, int* __restrict__ nlive) {
  __shared__ float span[kRankSpan];
  const int b = blockIdx.z;
  const int j = blockIdx.x * kRankThreads + threadIdx.x;
  const int i0 = blockIdx.y * kRankSpan;
  scores += (long long)b * n;
  for (int t = threadIdx.x; t < kRankSpan; t += kRankThreads) {
    span[t] = i0 + t < n ? scores[i0 + t] : 0.f;  // 0 never precedes
  }
  __syncthreads();
  const float sj = j < n ? scores[j] : 0.f;
  if (!(sj > 0.f)) return;  // not live (NaN included)
  int count = 0;
  for (int t = 0; t < kRankSpan; ++t) {
    const float si = span[t];
    count += (si > sj) | ((si == sj) & (i0 + t < j));
  }
  if (count) atomicAdd(rank + (long long)b * n + j, count);
  if (blockIdx.y == 0) atomicAdd(nlive + b, 1);
}

// order[rank[j]] = j for the live candidates.
__global__ void __launch_bounds__(kRankThreads)
    nms_order_kernel(const float* __restrict__ scores, int n,
                     const int* __restrict__ rank, int* __restrict__ order) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kRankThreads + threadIdx.x;
  if (j >= n || !(scores[(long long)b * n + j] > 0.f)) return;
  order[(long long)b * n + rank[(long long)b * n + j]] = j;
}

// The candidate's corners, its class, its box widened by kSkipMargin,
// and whether all its corners are finite. The corners are those of
// ops/iou_rotated.py:sincos_box_corners, operation for operation in
// round-to-nearest: the rectangle rotated about its center by
// [[cos, -sin], [sin, cos]].
struct Quad {
  float x[4], y[4];
  float lo_x, lo_y, hi_x, hi_y;
  float cls;
  bool finite;
};

__device__ __forceinline__ void load_quad(const float* __restrict__ boxes,
                                          const float* __restrict__ classes,
                                          int k, Quad* q) {
  const float* b = boxes + k * 6;
  const float x1 = b[0], y1 = b[1], x2 = b[2], y2 = b[3];
  const float sn = b[4], cs = b[5];
  const float cx = __fdiv_rn(__fadd_rn(x1, x2), 2.f);
  const float cy = __fdiv_rn(__fadd_rn(y1, y2), 2.f);
  const float xs[4] = {x1, x2, x2, x1};
  const float ys[4] = {y1, y1, y2, y2};
  q->finite = true;
  q->lo_x = q->lo_y = INFINITY;
  q->hi_x = q->hi_y = -INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float dx = __fsub_rn(xs[c], cx);
    const float dy = __fsub_rn(ys[c], cy);
    q->x[c] = __fadd_rn(__fsub_rn(__fmul_rn(dx, cs), __fmul_rn(dy, sn)), cx);
    q->y[c] = __fadd_rn(__fadd_rn(__fmul_rn(dy, cs), __fmul_rn(dx, sn)), cy);
    q->finite &= isfinite(q->x[c]) && isfinite(q->y[c]);
    q->lo_x = fminf(q->lo_x, q->x[c]);
    q->hi_x = fmaxf(q->hi_x, q->x[c]);
    q->lo_y = fminf(q->lo_y, q->y[c]);
    q->hi_y = fmaxf(q->hi_y, q->y[c]);
  }
  q->lo_x -= kSkipMargin;
  q->lo_y -= kSkipMargin;
  q->hi_x += kSkipMargin;
  q->hi_y += kSkipMargin;
  q->cls = classes[k];
}

// One 64 x 64 tile of ranks (rows i, columns j) of one image: the block
// loads the 128 quads, lists the pairs that need a clip (i < j, both
// live, one class, not skipped), clips them with every thread busy, and
// writes the tile's 64 row words.
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ classes,
                    const int* __restrict__ order,
                    const int* __restrict__ nlive, int n, int words,
                    float thr, unsigned long long* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  const int b = blockIdx.z;
  const int live = nlive[b];
  // upper triangle, and only tiles inside the live ranks (block-uniform)
  if (col_tile < row_tile || col_tile * kTile >= live) return;
  boxes += (long long)b * n * 6;
  classes += (long long)b * n;
  order += (long long)b * n;
  mask += (long long)b * n * words;

  __shared__ Quad rows[kTile], cols[kTile];
  __shared__ unsigned short pairs[kTile * kTile];
  __shared__ unsigned long long bits[kTile];
  __shared__ int npairs;
  const int tid = threadIdx.x;
  const int i0 = row_tile * kTile;
  const int j0 = col_tile * kTile;
  if (tid < kTile) {
    if (i0 + tid < live) {
      load_quad(boxes, classes, order[i0 + tid], &rows[tid]);
    }
    bits[tid] = 0ull;
  } else if (tid < 2 * kTile) {
    const int c = tid - kTile;
    if (j0 + c < live) load_quad(boxes, classes, order[j0 + c], &cols[c]);
  }
  if (tid == 0) npairs = 0;
  __syncthreads();

  // a skipped pair reads as IoU 0, which only a threshold >= 0 rejects
  const bool skip_ok = thr >= 0.f;
  for (int p = tid; p < kTile * kTile; p += kMaskThreads) {
    const int r = p / kTile, c = p % kTile;
    const int i = i0 + r, j = j0 + c;
    if (i >= j || j >= live) continue;  // i < j < live
    const Quad& w = rows[r];
    const Quad& q = cols[c];
    if (q.cls != w.cls) continue;
    const bool disjoint = q.lo_x > w.hi_x || w.lo_x > q.hi_x ||
                          q.lo_y > w.hi_y || w.lo_y > q.hi_y;
    if (skip_ok && q.finite && w.finite && disjoint) continue;
    pairs[atomicAdd(&npairs, 1)] = static_cast<unsigned short>(p);
  }
  __syncthreads();

  const int count = npairs;
  for (int k = tid; k < count; k += kMaskThreads) {
    const int r = pairs[k] / kTile, c = pairs[k] % kTile;
    float sx[4], sy[4], cx[4], cy[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sx[v] = cols[c].x[v];  // the later rank is the subject
      sy[v] = cols[c].y[v];
      cx[v] = rows[r].x[v];  // the earlier one the clip quad
      cy[v] = rows[r].y[v];
    }
    if (odtk::quad_iou(sx, sy, cx, cy) > thr) atomicOr(&bits[r], 1ull << c);
  }
  __syncthreads();
  if (tid < kTile && i0 + tid < live) {
    mask[(long long)(i0 + tid) * words + col_tile] = bits[tid];
  }
}

// The first rank >= pos of the image's `live` not set in `removed`, or
// live: a ballot over 32 words at a time (uniform across the warp).
__device__ __forceinline__ int next_open(
    const unsigned long long* removed, int pos, int live, int live_words,
    int lane) {
  for (int base = pos / kTile; base < live_words; base += 32) {
    const int w = base + lane;
    unsigned long long open = 0ull;
    if (w < live_words) {
      open = ~removed[w];
      if (w == pos / kTile) open &= ~0ull << (pos % kTile);
      if (w == live_words - 1 && live % kTile) {
        open &= (1ull << (live % kTile)) - 1ull;
      }
    }
    const unsigned hit = __ballot_sync(0xffffffffu, open != 0ull);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const unsigned long long bits = __shfl_sync(0xffffffffu, open, src);
      return (base + src) * kTile + __ffsll(static_cast<long long>(bits)) - 1;
    }
  }
  return live;
}

__global__ void __launch_bounds__(32)
    nms_scan_kernel(const float* __restrict__ scores,
                    const float* __restrict__ boxes,
                    const float* __restrict__ classes,
                    const int* __restrict__ order,
                    const int* __restrict__ nlive,
                    const unsigned long long* __restrict__ mask, int n,
                    int words, int ndet, int* __restrict__ kept,
                    float* __restrict__ out_s, float* __restrict__ out_b,
                    float* __restrict__ out_c) {
  __shared__ unsigned long long removed[kMaxWords];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int live = nlive[b];
  const int live_words = (live + kTile - 1) / kTile;
  scores += (long long)b * n;
  boxes += (long long)b * n * 6;
  classes += (long long)b * n;
  order += (long long)b * n;
  mask += (long long)b * n * words;
  kept += (long long)b * ndet;
  out_s += (long long)b * ndet;
  out_b += (long long)b * ndet * 6;
  out_c += (long long)b * ndet;
  for (int w = lane; w < live_words; w += 32) removed[w] = 0ull;
  __syncwarp();

  // The dependent chain of a step is the search in `removed` and the load
  // of the kept rank's mask row; the kept ranks go to scratch and the
  // outputs are gathered after the loop, off that chain.
  int d = 0;
  int next = 0;  // the first rank not yet decided
  while (d < ndet) {
    const int p = next_open(removed, next, live, live_words, lane);
    if (p >= live) break;  // uniform across the warp
    if (lane == 0) kept[d] = p;
    const unsigned long long* row = mask + (long long)p * words;
    for (int w = p / kTile + lane; w < live_words; w += 32) {
      removed[w] |= row[w];
    }
    __syncwarp();
    next = p + 1;
    ++d;
  }
  __syncwarp();

  for (int r = lane; r < ndet; r += 32) {
    if (r < d) {
      const int k = order[kept[r]];
      out_s[r] = scores[k];
      for (int c = 0; c < 6; ++c) out_b[r * 6 + c] = boxes[k * 6 + c];
      out_c[r] = classes[k];
    } else {  // rounds that recorded nothing stay zero
      out_s[r] = 0.f;
      for (int c = 0; c < 6; ++c) out_b[r * 6 + c] = 0.f;
      out_c[r] = 0.f;
    }
  }
}

}  // namespace

// scores [batch, n], boxes [batch, n, 6], classes [batch, n], all fp32
// and contiguous on the device -> out_s [batch, ndet], out_b [batch, ndet,
// 6], out_c [batch, ndet]. Scratch, one 8-byte aligned allocation of
// batch * (n * words * 8 + 4 * (2 * n + 1 + ndet)) bytes: the mask [batch,
// n, words] 64-bit words (words = ceil(n / 64)), then int32 rank [batch,
// n] and nlive [batch] (both zeroed here), order [batch, n] and the kept
// ranks [batch, ndet]. 0 < n <= 16384 (the wrapper checks). Returns the
// first CUDA error of the launches.
extern "C" int odtk_nms_rotated(const float* scores, const float* boxes,
                                const float* classes, int batch, int n,
                                int ndet, float thr, void* scratch,
                                float* out_s, float* out_b, float* out_c,
                                void* stream) {
  const int words = (n + kTile - 1) / kTile;
  if (n <= 0 || n > kMaxCandidates || batch <= 0 || ndet <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* mask = static_cast<unsigned long long*>(scratch);
  int* rank = reinterpret_cast<int*>(mask + (long long)batch * n * words);
  int* nlive = rank + (long long)batch * n;
  int* order = nlive + batch;
  int* kept = order + (long long)batch * n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      rank, 0, sizeof(int) * ((long long)batch * n + batch), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cand_blocks = (n + kRankThreads - 1) / kRankThreads;
  nms_count_kernel<<<dim3(cand_blocks, (n + kRankSpan - 1) / kRankSpan,
                          batch),
                     kRankThreads, 0, st>>>(scores, n, rank, nlive);
  nms_order_kernel<<<dim3(cand_blocks, batch), kRankThreads, 0, st>>>(
      scores, n, rank, order);
  nms_mask_kernel<<<dim3(words, words, batch), kMaskThreads, 0, st>>>(
      boxes, classes, order, nlive, n, words, thr, mask);
  nms_scan_kernel<<<batch, 32, 0, st>>>(scores, boxes, classes, order,
                                        nlive, mask, n, words, ndet, kept,
                                        out_s, out_b, out_c);
  return static_cast<int>(cudaGetLastError());
}
