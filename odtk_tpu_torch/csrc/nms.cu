// Greedy class-aware NMS over axis-aligned boxes as a parallel suppression
// bitmask: rank, mask, scan, four launches and a memset on the caller's
// stream.
//
// Replaces the TPU kernel odtk_tpu/ops/pallas/nms_kernel.py:nms_pallas
// (body _nms_kernel). Contract: D rounds of masked argmax (lowest index on
// ties) -> record the winner -> zero every live candidate of the same class
// whose IoU with it exceeds the threshold, and the winner itself. IoU uses
// +1-pixel widths; a round records only when its maximum is > 0, so a
// zeroed candidate never suppresses another; an image with a NaN score
// records nothing. Output is zero-padded and score-descending.
//
// Bound on the card: latency, not bytes or operations. The inputs are N*24
// bytes an image (48 KB at N = 2000), read once, and an IoU is ~14 fp32
// operations. Run as D rounds inside one block an image, the work is a
// dependent chain of D block-wide argmax reductions of three barriers each
// (~1.8 us a round), on 2 SMs of 132 at b = 2. Here the rounds are the scan
// of csrc/nms_scan.cuh, which this file shares with csrc/nms_rotated.cu:
// rank (two launches), this file's mask launch, and a one-warp scan whose
// dependent chain is ~D mask-row loads, not D block barriers.
//
// The mask (grid: 64 x 64 tiles of ranks, upper triangle, x images; 64
// threads a tile): thread r holds the box of rank i = i0 + r and walks the
// tile's 64 column ranks j > i in shared memory, setting bit j of its word
// iff the classes are equal and the IoU of candidate j against winner i is
// > thr. Every same-class pair is ~14 operations, so no pair is skipped and
// no pair list is needed; the word is built in a register and written once.
//
// Arithmetic is IEEE fp32 with explicit round-to-nearest intrinsics, in the
// plain version's order (candidate area + winner area), so no FMA
// contraction or approximate division changes an IoU that sits at the
// threshold; min, max and the clamp at 0 carry a NaN through as torch's do,
// so a NaN IoU sets no bit, as in the rounds. The IEEE division (a long
// instruction sequence) is taken only where the decision needs it: a fast
// approximate quotient decides a pair whose IoU is clearly above or below
// the threshold, with a margin far wider than its error. The result equals
// the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include <cmath>

#include "nms_scan.cuh"

namespace {

constexpr int kAxisMaskThreads = kTile;
// __fdividef is within 2 ulp (2^-22 relative) of the quotient for a
// divisor in [2^-126, 2^126]; a quotient more than 2^-18 relative away from
// a normal threshold in (0, 1) then rounds to the same side of it as the
// IEEE quotient does.
constexpr float kMargin = 1.f / (1 << 18);
constexpr float kDenLo = 1e-30f, kDenHi = 1e30f;

// torch.minimum / torch.maximum / clamp(min=0): NaN in, NaN out.
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float area_rn(float x1, float y1, float x2,
                                         float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.f));
}

// One 64 x 64 tile of ranks (rows i, columns j) of one image.
__global__ void __launch_bounds__(kAxisMaskThreads)
    nms_axis_mask_kernel(const float* __restrict__ boxes,
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
  boxes += (long long)b * n * 4;
  classes += (long long)b * n;
  order += (long long)b * n;
  mask += (long long)b * n * words;

  __shared__ float cx1[kTile], cy1[kTile], cx2[kTile], cy2[kTile];
  __shared__ float carea[kTile], ccls[kTile];
  const int tid = threadIdx.x;
  const int i = row_tile * kTile + tid;
  const int j0 = col_tile * kTile;
  if (j0 + tid < live) {
    const int k = order[j0 + tid];
    cx1[tid] = boxes[k * 4 + 0];
    cy1[tid] = boxes[k * 4 + 1];
    cx2[tid] = boxes[k * 4 + 2];
    cy2[tid] = boxes[k * 4 + 3];
    carea[tid] = area_rn(cx1[tid], cy1[tid], cx2[tid], cy2[tid]);
    ccls[tid] = classes[k];
  }
  float mx1 = 0.f, my1 = 0.f, mx2 = 0.f, my2 = 0.f, mc = 0.f;
  if (i < live) {
    const int k = order[i];
    mx1 = boxes[k * 4 + 0];
    my1 = boxes[k * 4 + 1];
    mx2 = boxes[k * 4 + 2];
    my2 = boxes[k * 4 + 3];
    mc = classes[k];
  }
  __syncthreads();
  if (i >= live) return;
  const float marea = area_rn(mx1, my1, mx2, my2);
  const bool fast = thr > kDenLo && thr < 1.f;
  const float thr_hi = thr * (1.f + kMargin), thr_lo = thr * (1.f - kMargin);
  const int first = col_tile == row_tile ? tid + 1 : 0;  // j > i
  const int last = min(kTile, live - j0);
  unsigned long long bits = 0ull;
  for (int c = first; c < last; ++c) {
    if (ccls[c] != mc) continue;
    const float iw = max_nan(
        __fadd_rn(__fsub_rn(min_nan(cx2[c], mx2), max_nan(cx1[c], mx1)), 1.f),
        0.f);
    const float ih = max_nan(
        __fadd_rn(__fsub_rn(min_nan(cy2[c], my2), max_nan(cy1[c], my1)), 1.f),
        0.f);
    const float inter = __fmul_rn(iw, ih);
    const float den = __fsub_rn(__fadd_rn(carea[c], marea), inter);
    // the IEEE division decides only near the threshold (see above)
    const float q = __fdividef(inter, den);
    const bool plain = den > kDenLo && den < kDenHi;
    bool over;
    if (fast && plain && q > thr_hi) {
      over = true;
    } else if (fast && plain && q >= 0.f && q < thr_lo) {
      over = false;
    } else {
      over = __fdiv_rn(inter, den) > thr;
    }
    if (over) bits |= 1ull << c;
  }
  mask[(long long)i * words + col_tile] = bits;
}

}  // namespace

// scores [batch, n], boxes [batch, n, 4], classes [batch, n], all fp32 and
// contiguous on the device -> out_s [batch, ndet], out_b [batch, ndet, 4],
// out_c [batch, ndet]. scratch: csrc/nms_scan.cuh's layout. 0 < n <= 16384
// (the wrapper checks). Returns the first CUDA error of the launches.
extern "C" int odtk_nms(const float* scores, const float* boxes,
                        const float* classes, int batch, int n, int ndet,
                        float thr, void* scratch, float* out_s, float* out_b,
                        float* out_c, void* stream) {
  if (n <= 0 || n > kMaxCandidates || batch <= 0 || ndet <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const NmsScratch s = nms_scratch(scratch, batch, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = nms_rank_step<4>(scores, batch, n, s, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_axis_mask_kernel<<<dim3(s.words, s.words, batch), kAxisMaskThreads, 0,
                         st>>>(boxes, classes, s.order, s.nlive, n, s.words,
                               thr, s.mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_scan_step<4>(scores, boxes, classes, batch, n,
                                           ndet, s, out_s, out_b, out_c,
                                           st));
}
