// Rotated anchor matcher: for every anchor quad, the best (IoU, target) over
// the targets of its image, by polygon clip (csrc/quad_iou.cuh).
//
// Replaces two TPU kernels:
// - odtk_tpu/ops/pallas/match_rotated_kernel.py:rotated_match_pallas
//   (_match_kernel), the batched matcher of every rotated training step:
//   per image the packed active targets (rows of quad + original slot, the
//   first n_act[b] of them active, in ascending slot order), a tile-AABB
//   skip, a strict '>' fold from (-2, slot 0). Entry odtk_match_rotated.
// - odtk_tpu/ops/pallas/iou_kernel.py:rotated_best_match_pallas, taken here
//   with the semantics of the JAX jnp form rotated_best_match that it
//   stands for: one image, every target visited, an invalid one counting as
//   IoU -1, no skip, index = target row. Entry odtk_rotated_best_match, the
//   template flag kBatched = false of the same kernel.
//
// Bound on the card: operations. Each (anchor, target) pair that is
// clipped costs ~1000 fp32 operations for 32 bytes of anchor read and 8 of
// output written per anchor, so the work is the pairs the skip lets
// through. The design: grid (anchor tiles of 256, images); one thread per
// anchor holds its quad in registers; the block copies its image's target
// rows (at most 128 x 9 floats) to shared memory once. Consecutive anchor
// indices are one strip of cells, so the block reduces its tile's AABB and
// tests each target's AABB against it: the test is the same for every
// thread of the block, so a miss costs four compares and no divergence,
// and a hit clips all 256 anchors. Outputs are written once, two planes.
//
// The tile skip changes which anchors no target reached (they keep IoU -2
// and slot 0): a skipped target's AABB misses the anchor's, so its IoU is
// 0. Wherever the plain fold's best IoU is > 0 the kernel's equals it, IoU
// and slot; elsewhere both are <= 0 (background). The plain version
// (ops/kernels/match_rotated.py) has no tile skip.

#include <cuda_runtime.h>

#include <cmath>

#include "quad_iou.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWidth = 9;  // 4 corners (x, y), slot or valid flag

template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
    match_kernel(const float* __restrict__ anchors,
                 const float* __restrict__ rows,
                 const int* __restrict__ n_act, int n, int m,
                 float* __restrict__ best_iou, int* __restrict__ best_slot) {
  extern __shared__ float srow[];  // [m, 9]
  __shared__ float red[4][kWarps];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  rows += (long long)b * m * kRowWidth;
  const int count = kBatched ? n_act[b] : m;
  for (int k = tid; k < count * kRowWidth; k += kThreads) srow[k] = rows[k];

  const bool live = i < n;
  float ax[4], ay[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = live ? anchors[(long long)i * 8 + 2 * k] : 0.f;
    ay[k] = live ? anchors[(long long)i * 8 + 2 * k + 1] : 0.f;
  }

  float tx1 = 0.f, tx2 = 0.f, ty1 = 0.f, ty2 = 0.f;
  if (kBatched) {  // the tile's AABB over its live anchors
    float x1 = live ? fminf(fminf(ax[0], ax[1]), fminf(ax[2], ax[3]))
                    : INFINITY;
    float x2 = live ? fmaxf(fmaxf(ax[0], ax[1]), fmaxf(ax[2], ax[3]))
                    : -INFINITY;
    float y1 = live ? fminf(fminf(ay[0], ay[1]), fminf(ay[2], ay[3]))
                    : INFINITY;
    float y2 = live ? fmaxf(fmaxf(ay[0], ay[1]), fmaxf(ay[2], ay[3]))
                    : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x1 = fminf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      x2 = fmaxf(x2, __shfl_xor_sync(0xffffffffu, x2, off));
      y1 = fminf(y1, __shfl_xor_sync(0xffffffffu, y1, off));
      y2 = fmaxf(y2, __shfl_xor_sync(0xffffffffu, y2, off));
    }
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = x1;
      red[1][tid >> 5] = x2;
      red[2][tid >> 5] = y1;
      red[3][tid >> 5] = y2;
    }
    __syncthreads();
    tx1 = red[0][0];
    tx2 = red[1][0];
    ty1 = red[2][0];
    ty2 = red[3][0];
    for (int w = 1; w < kWarps; ++w) {
      tx1 = fminf(tx1, red[0][w]);
      tx2 = fmaxf(tx2, red[1][w]);
      ty1 = fminf(ty1, red[2][w]);
      ty2 = fmaxf(ty2, red[3][w]);
    }
  } else {
    __syncthreads();  // the rows are in shared memory
  }

  float best = -2.f;
  int slot = 0;
  for (int t = 0; t < count; ++t) {
    const float* r = srow + t * kRowWidth;
    const float cx[4] = {r[0], r[2], r[4], r[6]};
    const float cy[4] = {r[1], r[3], r[5], r[7]};
    if (kBatched) {
      const float bx1 = fminf(fminf(cx[0], cx[1]), fminf(cx[2], cx[3]));
      const float bx2 = fmaxf(fmaxf(cx[0], cx[1]), fmaxf(cx[2], cx[3]));
      const float by1 = fminf(fminf(cy[0], cy[1]), fminf(cy[2], cy[3]));
      const float by2 = fmaxf(fmaxf(cy[0], cy[1]), fmaxf(cy[2], cy[3]));
      if (!(bx1 <= tx2 && bx2 >= tx1 && by1 <= ty2 && by2 >= ty1)) {
        continue;  // block-uniform: no anchor of the tile can overlap
      }
      if (!live) continue;
      const float iou = odtk::quad_iou(ax, ay, cx, cy);
      if (iou > best) {
        best = iou;
        slot = static_cast<int>(r[8]);
      }
    } else {
      if (!live) continue;
      const float iou = r[8] > 0.f ? odtk::quad_iou(ax, ay, cx, cy) : -1.f;
      if (iou > best) {
        best = iou;
        slot = t;
      }
    }
  }
  if (live) {
    best_iou[(long long)b * n + i] = best;
    best_slot[(long long)b * n + i] = slot;
  }
}

int launch(bool batched, const float* anchors, const float* rows,
           const int* n_act, int batch, int n, int m, float* best_iou,
           int* best_slot, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch), block(kThreads);
  const size_t smem = size_t(m) * kRowWidth * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (batched) {
    err = cudaFuncSetAttribute(match_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    match_kernel<true><<<grid, block, smem, st>>>(anchors, rows, n_act, n, m,
                                                  best_iou, best_slot);
  } else {
    err = cudaFuncSetAttribute(match_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    match_kernel<false><<<grid, block, smem, st>>>(anchors, rows, n_act, n, m,
                                                   best_iou, best_slot);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// anchors [n, 8], rows [batch, m, 9] (quad, original slot; the first
// n_act[b] rows of image b active), n_act [batch] int32 -> best_iou
// [batch, n] fp32, best_slot [batch, n] int32. All contiguous on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int odtk_match_rotated(const float* anchors, const float* rows,
                                  const int* n_act, int batch, int n, int m,
                                  float* best_iou, int* best_slot,
                                  void* stream) {
  return launch(true, anchors, rows, n_act, batch, n, m, best_iou, best_slot,
                stream);
}

// anchors [n, 8], rows [m, 9] (quad, valid flag 1 or 0) -> best_iou [n]
// fp32, best_idx [n] int32. All contiguous on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int odtk_rotated_best_match(const float* anchors, const float* rows,
                                       int n, int m, float* best_iou,
                                       int* best_idx, void* stream) {
  return launch(false, anchors, rows, nullptr, 1, n, m, best_iou, best_idx,
                stream);
}
