// Greedy class-aware NMS over rotated boxes, one thread block per image.
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
// score-descending. The corner quads come in precomputed
// (sincos_box_corners, the function the plain version uses).
//
// Bound on the card: latency. The inputs are N*(4+24+32+4) bytes per image
// (128 KB at N = 2000), read once; the cost is D = 100 dependent rounds, each
// a block-wide argmax, two barriers and one polygon clip (~1000 fp32
// operations) per live same-class candidate. With b = 2 the grid is two
// blocks on a 132-SM card. The design: scores and classes stay in shared
// memory for all rounds (8 bytes a candidate, so N up to 16384), each of
// the 256 threads owns candidates tid, tid+256, ...; a round is a shuffle
// argmax, one shared-memory pass over the 8 warp winners, and a broadcast
// of the winner's quad and class. A thread clips only its candidates that
// are still live and of the winner's class: a zero score stays zero and a
// class mismatch never suppresses, so skipping them changes nothing. 256
// threads give each thread up to 255 registers for the ~80 live floats of
// the clip, which the 1024-thread layout of csrc/nms.cu (64 registers a
// thread) would spill. The loop ends when a round's maximum is <= 0.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "quad_iou.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCandidates = 16384;  // 8 bytes each of dynamic shared memory

// (val, idx) beats (best_val, best_idx): higher score, lowest index on ties.
__device__ __forceinline__ bool better(float val, int idx, float best_val,
                                       int best_idx) {
  return val > best_val || (val == best_val && idx < best_idx);
}

__global__ void __launch_bounds__(kThreads)
    nms_rotated_kernel(const float* __restrict__ scores,
                       const float* __restrict__ boxes,
                       const float* __restrict__ corners,
                       const float* __restrict__ classes, int n, int ndet,
                       float thr, float* __restrict__ out_s,
                       float* __restrict__ out_b, float* __restrict__ out_c) {
  extern __shared__ float smem[];
  float* s = smem;       // [n] live scores
  float* cls = smem + n;  // [n] classes
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  scores += (long long)b * n;
  boxes += (long long)b * n * 6;
  corners += (long long)b * n * 8;
  classes += (long long)b * n;
  out_s += (long long)b * ndet;
  out_b += (long long)b * ndet * 6;
  out_c += (long long)b * ndet;

  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ float win_val;
  __shared__ int win_idx;
  __shared__ float win_quad[9];  // 4 corners (x, y), class

  for (int i = tid; i < n; i += kThreads) {
    s[i] = scores[i];
    cls[i] = classes[i];
  }
  __syncthreads();

  int d = 0;
  for (; d < ndet; ++d) {
    // this thread's candidates run in increasing index order, so a strict
    // '>' keeps the lowest index among equal scores
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      if (s[i] > bv) {
        bv = s[i];
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      bv = warp_val[0];
      bi = warp_idx[0];
      for (int w = 1; w < kWarps; ++w) {
        if (better(warp_val[w], warp_idx[w], bv, bi)) {
          bv = warp_val[w];
          bi = warp_idx[w];
        }
      }
      win_val = bv;
      win_idx = bi;
      if (bv > 0.f) {
        for (int k = 0; k < 8; ++k) win_quad[k] = corners[bi * 8 + k];
        win_quad[8] = cls[bi];
        out_s[d] = bv;
        for (int k = 0; k < 6; ++k) out_b[d * 6 + k] = boxes[bi * 6 + k];
        out_c[d] = cls[bi];
      }
    }
    __syncthreads();
    const float m_val = win_val;
    const int m_idx = win_idx;
    if (!(m_val > 0.f)) break;  // uniform across the block

    float cx[4], cy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cx[k] = win_quad[2 * k];
      cy[k] = win_quad[2 * k + 1];
    }
    const float mc = win_quad[8];
    for (int i = tid; i < n; i += kThreads) {
      if (i == m_idx) {
        s[i] = 0.f;
        continue;
      }
      if (s[i] == 0.f || cls[i] != mc) continue;
      float sx[4], sy[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sx[k] = corners[i * 8 + 2 * k];
        sy[k] = corners[i * 8 + 2 * k + 1];
      }
      if (odtk::quad_iou(sx, sy, cx, cy) > thr) s[i] = 0.f;
    }
    __syncthreads();
  }

  // rounds that recorded nothing stay zero
  for (int r = d + tid; r < ndet; r += kThreads) {
    out_s[r] = 0.f;
    for (int k = 0; k < 6; ++k) out_b[r * 6 + k] = 0.f;
    out_c[r] = 0.f;
  }
}

}  // namespace

// scores [batch, n], boxes [batch, n, 6], corners [batch, n, 8], classes
// [batch, n], all fp32 and contiguous on the device -> out_s [batch, ndet],
// out_b [batch, ndet, 6], out_c [batch, ndet]. n <= 16384 (the wrapper
// checks). Returns cudaGetLastError() after the launch.
extern "C" int odtk_nms_rotated(const float* scores, const float* boxes,
                                const float* corners, const float* classes,
                                int batch, int n, int ndet, float thr,
                                float* out_s, float* out_b, float* out_c,
                                void* stream) {
  if (n > kMaxCandidates) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = size_t(n) * 2 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_rotated_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_rotated_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      scores, boxes, corners, classes, n, ndet, thr, out_s, out_b, out_c);
  return static_cast<int>(cudaGetLastError());
}
