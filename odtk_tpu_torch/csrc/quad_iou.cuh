// IoU of one subject quad against one clip quad by Sutherland-Hodgman
// clipping, for one thread: shared by csrc/nms_rotated.cu and
// csrc/match_rotated.cu.
//
// The device twin of odtk_tpu_torch/ops/iou_rotated.py:_soa_clip_iou for one
// subject, itself the operation order of the JAX package's
// odtk_tpu/ops/iou_rotated.py:_soa_clip_iou: 8 vertex slots kept in
// registers, four clip edges, each emitting (vertex j, intersection j)
// candidates compacted in that order, slots past 8 dropped while the count
// goes on, the +0.001 pad on subject coordinates equal to the clip's
// matching corner coordinate, the areas from the raw corners, and the NaN
// rules (inter and union NaN -> 1, inter NaN -> 0).
//
// Every operation is an IEEE round-to-nearest intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn), which nvcc never contracts into a fused
// multiply-add, in the plain version's order: the kernel's IoU equals the
// plain PyTorch version's bit for bit, so a threshold or a tie decides the
// same way on both. Slot indices are compile-time constants after
// unrolling, so the polygon stays in registers; a candidate lands in its
// output slot through selects, not a dynamically indexed array.

#pragma once

#include <cuda_runtime.h>

namespace odtk {

constexpr int kSlots = 8;

// Half the shoelace area of the subject quad (its raw corners), rounded
// as the clip rounds it.
__device__ __forceinline__ float subject_half_area(const float sxr[4],
                                                   const float syr[4]) {
  float subj_area2 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = (j + 1) % 4;
    subj_area2 = __fadd_rn(subj_area2, __fsub_rn(__fmul_rn(sxr[j], syr[k]),
                                                 __fmul_rn(syr[j], sxr[k])));
  }
  return __fdiv_rn(fabsf(subj_area2), 2.f);
}

// The same for the clip quad, whose terms the clip sums in another order.
__device__ __forceinline__ float clip_half_area(const float cx[4],
                                                const float cy[4]) {
  float clip_area2 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = (j + 1) % 4;
    clip_area2 = __fsub_rn(__fadd_rn(clip_area2, __fmul_rn(cx[j], cy[k])),
                           __fmul_rn(cy[j], cx[k]));
  }
  return __fdiv_rn(fabsf(clip_area2), 2.f);
}

// IoU of the subject (sxr, syr: its 4 raw corners) clipped against the
// quad (cx, cy: 4 corners), given their union
// uni = subject_half_area + clip_half_area (__fadd_rn).
__device__ __forceinline__ float quad_iou(const float sxr[4],
                                          const float syr[4],
                                          const float cx[4],
                                          const float cy[4], float uni) {
  float sx[kSlots], sy[kSlots];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sx[k] = sxr[k] == cx[k] ? __fadd_rn(sxr[k], 0.001f) : sxr[k];
    sy[k] = syr[k] == cy[k] ? __fadd_rn(syr[k], 0.001f) : syr[k];
    sx[k + 4] = 0.f;
    sy[k + 4] = 0.f;
  }

  int count = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v1x = cx[e], v1y = cy[e];
    const float v2x = cx[(e + 1) % 4], v2y = cy[(e + 1) % 4];
    const float a = __fsub_rn(v2y, v1y);
    const float b = __fsub_rn(v1x, v2x);
    const float c = __fsub_rn(__fmul_rn(v2x, v1y), __fmul_rn(v2y, v1x));

    float lv[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      lv[j] = __fadd_rn(__fadd_rn(__fmul_rn(a, sx[j]), __fmul_rn(b, sy[j])),
                        c);
    }
    float ox[kSlots], oy[kSlots];
#pragma unroll
    for (int o = 0; o < kSlots; ++o) {
      ox[o] = 0.f;
      oy[o] = 0.f;
    }
    int run = 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool wrap = j + 1 < count;
      const int s = (j + 1) % kSlots;
      const float nx = wrap ? sx[s] : sx[0];
      const float ny = wrap ? sy[s] : sy[0];
      const float nlv = wrap ? lv[s] : lv[0];
      const bool in_poly = j < count;
      if (in_poly && lv[j] <= 0.f) {  // the vertex
#pragma unroll
        for (int o = 0; o < kSlots; ++o) {
          if (run == o) {
            ox[o] = sx[j];
            oy[o] = sy[j];
          }
        }
        ++run;
      }
      if (in_poly && __fmul_rn(lv[j], nlv) <= 0.f) {  // the crossing
        const float a2 = __fsub_rn(ny, sy[j]);
        const float b2 = __fsub_rn(sx[j], nx);
        const float c2 = __fsub_rn(__fmul_rn(nx, sy[j]), __fmul_rn(ny, sx[j]));
        const float w = __fsub_rn(__fmul_rn(a, b2), __fmul_rn(b, a2));
        const float ix =
            __fdiv_rn(__fsub_rn(__fmul_rn(b, c2), __fmul_rn(c, b2)), w);
        const float iy =
            __fdiv_rn(__fsub_rn(__fmul_rn(c, a2), __fmul_rn(a, c2)), w);
#pragma unroll
        for (int o = 0; o < kSlots; ++o) {
          if (run == o) {
            ox[o] = ix;
            oy[o] = iy;
          }
        }
        ++run;
      }
    }
#pragma unroll
    for (int o = 0; o < kSlots; ++o) {
      sx[o] = ox[o];
      sy[o] = oy[o];
    }
    count = run;
  }

  float inter2 = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const bool wrap = j + 1 < count;
    const int s = (j + 1) % kSlots;
    const float nx = wrap ? sx[s] : sx[0];
    const float ny = wrap ? sy[s] : sy[0];
    const float term =
        j < count ? __fsub_rn(__fmul_rn(sx[j], ny), __fmul_rn(sy[j], nx))
                  : 0.f;
    inter2 = __fadd_rn(inter2, term);
  }
  const float inter = count > 2 ? __fdiv_rn(fabsf(inter2), 2.f) : 0.f;
  const float iou = __fdiv_rn(inter, __fsub_rn(uni, inter));
  if (isnan(inter)) return isnan(uni) ? 1.f : 0.f;
  return iou;
}

__device__ __forceinline__ float quad_iou(const float sxr[4],
                                          const float syr[4],
                                          const float cx[4],
                                          const float cy[4]) {
  return quad_iou(sxr, syr, cx, cy,
                  __fadd_rn(subject_half_area(sxr, syr),
                            clip_half_area(cx, cy)));
}

}  // namespace odtk
