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
// The rank and scan steps, the NaN-score rule (an image with a NaN score
// records nothing) and the scratch are csrc/nms_scan.cuh's, shared with
// the axis-aligned csrc/nms.cu; this file holds the mask step.
//
// Bound on the card: operations, the clips. The inputs are N*(4+24+4)
// bytes an image (64 KB at N = 2000), read once; the work is one polygon
// clip (~276-1000 dependent fp32 operations) per same-class pair that can
// overlap. The round loop of one block per image that this file held before
// ran those clips 100 rounds deep on two SMs of 132. The design takes the
// clips out of the dependent chain: the mask launch (grid: 64 x 64 tiles
// of ranks, upper triangle, x images) sets bit (i, j) of the image's
// [N, ceil(N/64)] 64-bit mask, i ranked before j, iff cls[i] == cls[j]
// and quad_iou(subject j, clip i) > thr. A tile's block first lists the
// pairs that need a clip, then clips the list with all 256 threads, so a
// warp does not idle on the lanes whose pair was skipped or of another
// class. A clip is skipped only where its answer is provably <= thr: both
// quads finite and their axis-aligned boxes, widened by kSkipMargin (well
// over the 0.001 pad and the rounding of the clip), disjoint, and thr >= 0.
// A non-finite quad is always clipped (quad_iou's NaN rule gives 1.0 when
// both intersection and union are NaN). Tiles past the image's live count
// exit at once. (A scan loading the rows of the next 8 open ranks at once
// measured slower on the real candidates: most of the 8 are removed by the
// first.)

#include <cuda_runtime.h>

#include <cmath>

#include "nms_scan.cuh"
#include "quad_iou.cuh"

namespace {

constexpr int kMaskThreads = 256;
// A clip over disjoint boxes ends with count <= 2 vertices (inter 0) unless
// rounding keeps a vertex within a few ulps of both quads; coordinates
// below ~1e4 round by < 1e-3, so a gap of 0.25 after the 0.001 pad leaves
// no such vertex.
constexpr float kSkipMargin = 0.25f;

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

}  // namespace

// scores [batch, n], boxes [batch, n, 6], classes [batch, n], all fp32
// and contiguous on the device -> out_s [batch, ndet], out_b [batch, ndet,
// 6], out_c [batch, ndet]. scratch: csrc/nms_scan.cuh's layout. 0 < n <=
// 16384 (the wrapper checks). Returns the first CUDA error of the launches.
extern "C" int odtk_nms_rotated(const float* scores, const float* boxes,
                                const float* classes, int batch, int n,
                                int ndet, float thr, void* scratch,
                                float* out_s, float* out_b, float* out_c,
                                void* stream) {
  if (n <= 0 || n > kMaxCandidates || batch <= 0 || ndet <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const NmsScratch s = nms_scratch(scratch, batch, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = nms_rank_step<6>(scores, batch, n, s, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_mask_kernel<<<dim3(s.words, s.words, batch), kMaskThreads, 0, st>>>(
      boxes, classes, s.order, s.nlive, n, s.words, thr, s.mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_scan_step<6>(scores, boxes, classes, batch, n,
                                           ndet, s, out_s, out_b, out_c,
                                           st));
}
