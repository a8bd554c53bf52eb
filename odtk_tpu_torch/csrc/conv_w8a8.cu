// w8a8 convolution: the activations quantized to int8 with the layer's
// calibrated per-tensor scale, int8 x int8 products summed in int32, and the
// sums rescaled per output channel:
//
//   xq  = clip(rint(x / act_scale), -127, 127) as int8  (NaN -> 0)
//   acc = int32 sum of xq * wq over (kh, kw, cin / groups), zero padding
//   y   = float(acc) * (act_scale * w_scale[o]) + bias[o], in out's dtype
//
// Replaces no Pallas kernel: the JAX package computes this convolution in
// XLA (odtk_tpu/backbones/layers.py:QuantConv, its w8a8 branch,
// lax.conv_general_dilated(..., preferred_element_type=jnp.int32)); the port
// has no int8 convolution to call, so the operator is written here.
//
// The sums are exact (the widest contraction of the repo's models is P6's
// 3 x 3 conv over 2048 channels: |acc| <= 18432 * 127^2 < 2^31), and so is
// any split of them: int32 partial sums added in any order give the same
// int32. The quotient and the epilogue are IEEE fp32 with explicit
// round-to-nearest intrinsics (no FMA contraction), so the result equals the
// plain version (ops/kernels/conv_w8a8.py:conv_w8a8_plain) bit for bit.
//
// The kernels, launched one after the other on the caller's stream:
//   (a) quantize_nhwc: x NCHW (fp32 or bf16) -> xq int8 NHWC, channels
//       padded with zeros to Cp (4 for up to 4 channels, the stem's 3; else
//       a multiple of 16). A tiled transpose: a
//       block quantizes 64 pixels x 64 channels (256 x 16 for Cp = 16), a
//       warp reading 32 consecutive pixels of one channel plane, and writes
//       each pixel's channels as 16-byte words. It multiplies by the
//       reciprocal and divides only where that could round otherwise.
//   (b) conv_wgmma (groups == 1): an implicit GEMM, M = B Ho Wo output
//       pixels, N = Cout, K = kh kw Cp in (kh, kw, c) order; both operands
//       K-major, as 8-bit wgmma requires: A the window rows of xq, B the
//       weight as the module stores it, [Cout, kh kw Cp]. Work units are
//       128 x BN output tiles (BN = 64, 128 or 256) over a slice of K; the
//       grid is persistent, a block of three warpgroups an SM walking the
//       units, with K in 128-byte slabs through a ring of 4-8 stages (192
//       KB) whose rows carry the 128-byte swizzle, under full / empty
//       mbarriers:
//       - the producer warpgroup (setmaxnreg 56): B by TMA; A by TMA too for
//         a 1 x 1 stride-1 call (the NHWC copy is then the A matrix itself),
//         else gathered by cp.async, 16 bytes a thread a row (4-byte taps
//         for Cp = 4, B's rows too: kh kw 4 bytes are no TMA row), padding
//         and K's tail zero-filled, completion signalled by
//         cp.async.mbarrier.arrive;
//       - two consumer warpgroups (setmaxnreg 224), 64 rows each, run
//         wgmma.mma_async m64n64k32 / m64n128k32 s32.s8.s8 from shared
//         memory, one group of four (K = 128) a stage in flight;
//       - the epilogue stages the int32 tile, 64 channels at a time, in a
//         buffer of its own, channel-major, and writes it out as runs of
//         consecutive pixels of each channel plane: rescaled into NCHW (a
//         tile may cross an image boundary), or, when K is split, the raw
//         sums into a workspace. Meanwhile the producer loads the next
//         unit's K slabs.
//   (c) conv_finish (a split K): sums the workspace's slices in order,
//       rescales and writes NCHW, coalesced on both sides.
//   (d) conv_direct (groups > 1, the depthwise convs of MobileNetV2FPN):
//       one thread an output, an int32 dot over kh kw cin/groups; tensor-core
//       tiles would be nearly empty at K = 9.
//
// The launch plan (BN, the split of K, the A route) comes from the call's
// shapes alone (ops/kernels/conv_w8a8.py:plan), and is checked here.
//
// Bound on the card (1979 int8 TOP/s, 3.35 TB/s; x read once, y written
// once): at ResNet50FPN's shapes (b=2, 896 x 1408) the P3-P6 heads, the FPN
// smooths and layer3-4's 3 x 3 convs are bound by the int8 operations, the
// rest by bytes (0.68 of the forward's 1.10 ms). What holds each kind of
// call, and what the design does about it:
// - many tiles, bound by operations (the P3 and P4 heads): the tensor
//   cores fed from shared memory. Only wgmma reaches the int8 rate; a
//   128 x 256 tile loads half the L2 bytes a product of a 128 x 64 one;
//   the epilogue's 16-byte runs keep the stores from outlasting the MMA.
// - short K, bound by bytes (the 1 x 1 convs, conv1): the quantize pass's
//   round trip and the output's stores. The pass writes whole sectors, a
//   1 x 1 call reads its copy by TMA, conv1 packs 3 channels in 4 bytes a
//   tap (K = 196, not 784), and the persistent grid loads the next unit
//   while the last is written out.
// - few tiles (layer4, P6, P7, the P5-P7 heads: 2-80 blocks of the first
//   design's grid): idle SMs and fixed costs. The plan narrows the tile
//   and splits K where its cost model, fitted on this card, rates that
//   cheaper than the finish pass it costs.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// torch.round (half to even) of the IEEE quotient, clamped to +-127; NaN
// -> 0 (fminf / fmaxf would give -127), +-inf -> +-127.
__device__ __forceinline__ int quantize(float v, float act_scale) {
  const float q = rintf(__fdiv_rn(v, act_scale));
  if (isnan(q)) return 0;
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// y = float(acc) * (act_scale * w_scale) + bias, each step rounded.
__device__ __forceinline__ float rescale(int acc, float act_scale,
                                         float w_scale, const float* bias,
                                         int n) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(act_scale, w_scale));
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  return v;
}

// out[idx] = v in the output dtype (1: bf16, else fp32)
__device__ __forceinline__ void store_out(void* out, int out_bf16,
                                          long long idx, float v) {
  if (out_bf16) {
    store(static_cast<__nv_bfloat16*>(out) + idx, v);
  } else {
    store(static_cast<float*>(out) + idx, v);
  }
}

// ------------------------------------------------ (a) quantize pass

// x * fl(1 / act_scale) is within 2.3e-5 of the IEEE quotient fl(x /
// act_scale) where |x / act_scale| < 128 (three roundings of 2^-24
// relative each), so where it is further than kQuantMargin from a half
// code both round to the same code: the pass divides only near a half
// code, outside +-128, and for NaN.
constexpr float kQuantMargin = 4e-5f;

__device__ __forceinline__ int quantize_fast(float v, float act_scale,
                                             float inv_scale) {
  const float t = __fmul_rn(v, inv_scale);
  const float f = __fsub_rn(t, floorf(t));
  if (fabsf(t) < 128.f && fabsf(__fsub_rn(f, 0.5f)) > kQuantMargin) {
    return static_cast<int>(fminf(fmaxf(rintf(t), -127.f), 127.f));
  }
  return quantize(v, act_scale);
}

constexpr int kQuantThreads = 256;
constexpr int kQuantElems = 4096;  // values a block: few enough that the
                                   // late layers' small tensors spread

// A block quantizes kQuantElems / CH pixels x CH channels (CH = 16 for
// Cp = 16, the stem's 3 channels, else 64). Reads: 16-byte loads of
// consecutive pixels of one channel plane (8 bf16 or 4 fp32; scalar loads
// when a run could cross an image, hw not a multiple of the run, or x is
// not 16-byte aligned), a warp 512 contiguous bytes; the codes go to a
// pixel-major tile whose rows are CH + 4 bytes apart. Writes: 16-byte words
// of a pixel's channels. Indices fit in int: B H W Cp < 2^31.
template <typename T, int CH>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_nhwc_kernel(const T* __restrict__ x,
                         const float* __restrict__ act_scale,
                         int8_t* __restrict__ xq, int pixels, int C, int hw,
                         int Cp, int vector_loads) {
  constexpr int kVec = 16 / sizeof(T);       // pixels a load
  constexpr int kPix = kQuantElems / CH;     // pixels a block
  constexpr int kRuns = kPix / kVec;         // loads a channel row
  constexpr int kPitch = CH + 4;
  __shared__ __align__(16) int8_t tile[kPix * kPitch];
  const int p0 = blockIdx.x * kPix;
  const int c0 = blockIdx.y * CH;
  const float s = *act_scale;
  const float inv = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < CH * kRuns / kQuantThreads; ++i) {
    const int load = threadIdx.x + i * kQuantThreads;
    const int cl = load / kRuns;
    const int pl = (load % kRuns) * kVec;
    const int c = c0 + cl;
    const int pix = p0 + pl;
    float v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    if (c < C && pix < pixels) {
      if (vector_loads && pix + kVec <= pixels) {
        const int b = pix / hw;
        const T* src = x + (b * C + c) * hw + (pix - b * hw);
        alignas(16) T run[kVec];
        *reinterpret_cast<uint4*>(run) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = to_float(run[e]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int q = pix + e;
          if (q < pixels) {
            const int b = q / hw;
            v[e] = to_float(x[(b * C + c) * hw + (q - b * hw)]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      tile[(pl + e) * kPitch + cl] = static_cast<int8_t>(
          c < C ? quantize_fast(v[e], s, inv) : 0);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPix * CH / 16 / kQuantThreads; ++i) {
    const int word = threadIdx.x + i * kQuantThreads;
    const int wp = word / (CH / 16), wc = (word % (CH / 16)) * 16;
    const int opix = p0 + wp;
    if (opix < pixels && c0 + wc < Cp) {
      const unsigned* src =
          reinterpret_cast<const unsigned*>(tile + wp * kPitch + wc);
      *reinterpret_cast<uint4*>(xq + static_cast<long long>(opix) * Cp + c0 +
                                wc) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  }
}

// Cp = 4 (C <= 4, the stem's 3 channels): a thread quantizes a run of 8
// (bf16) or 4 (fp32) pixels of every channel and writes each pixel's codes
// as one 4-byte word, the run as 16-byte stores.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_nhwc4_kernel(const T* __restrict__ x,
                          const float* __restrict__ act_scale,
                          int8_t* __restrict__ xq, int pixels, int C, int hw,
                          int vector_loads) {
  constexpr int kVec = 16 / sizeof(T);
  const int pix = (blockIdx.x * kQuantThreads + threadIdx.x) * kVec;
  if (pix >= pixels) return;
  const float s = *act_scale;
  const float inv = __frcp_rn(s);
  const bool whole = vector_loads && pix + kVec <= pixels;
  unsigned word[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) word[e] = 0;
  for (int c = 0; c < C; ++c) {
    float v[kVec];
    if (whole) {
      const int b = pix / hw;
      alignas(16) T run[kVec];
      *reinterpret_cast<uint4*>(run) = *reinterpret_cast<const uint4*>(
          x + (b * C + c) * hw + (pix - b * hw));
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = to_float(run[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int q = pix + e;
        const int b = q / hw;
        v[e] = q < pixels ? to_float(x[(b * C + c) * hw + (q - b * hw)]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      word[e] |= (static_cast<unsigned>(quantize_fast(v[e], s, inv)) & 0xFFu)
                 << (8 * c);
    }
  }
  if (whole) {
    uint4* dst =
        reinterpret_cast<uint4*>(xq + static_cast<long long>(pix) * 4);
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      dst[e / 4] = make_uint4(word[e], word[e + 1], word[e + 2], word[e + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (pix + e < pixels) {
        reinterpret_cast<unsigned*>(xq)[pix + e] = word[e];
      }
    }
  }
}

template <typename T>
void launch_quantize(const T* x, const float* act_scale, int8_t* xq,
                     int pixels, int C, int hw, int Cp, cudaStream_t st) {
  const int vector_loads = hw % (16 / sizeof(T)) == 0 &&
                           reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (Cp == 4) {
    constexpr int kRun = kQuantThreads * 16 / sizeof(T);  // pixels a block
    quantize_nhwc4_kernel<T><<<(pixels + kRun - 1) / kRun, kQuantThreads, 0,
                               st>>>(x, act_scale, xq, pixels, C, hw,
                                     vector_loads);
  } else if (Cp == 16) {
    const dim3 grid((pixels + kQuantElems / 16 - 1) / (kQuantElems / 16), 1);
    quantize_nhwc_kernel<T, 16><<<grid, kQuantThreads, 0, st>>>(
        x, act_scale, xq, pixels, C, hw, Cp, vector_loads);
  } else {
    const dim3 grid((pixels + kQuantElems / 64 - 1) / (kQuantElems / 64),
                    (Cp + 63) / 64);
    quantize_nhwc_kernel<T, 64><<<grid, kQuantThreads, 0, st>>>(
        x, act_scale, xq, pixels, C, hw, Cp, vector_loads);
  }
}

// ------------------------------------------------ (b) wgmma implicit GEMM

constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kBM = 128;        // output pixels a tile: 64 a consumer
constexpr int kBK = 128;        // contraction bytes a stage: one swizzle row
constexpr int kRing = 196608;   // bytes of the stage ring
constexpr int kMaxStages = 8;
constexpr int kPitch = 132;     // int32 words of a staged channel row: the
                                // fragment stores of a warp hit 32 banks
constexpr int kEpiCols = 64;    // output channels the epilogue stages at once
constexpr int kEpiBytes = kEpiCols * kPitch * 4;
constexpr int kSmemBytes = kRing + kEpiBytes + 1024;  // + the ring's align
// setmaxnreg moves registers between the warpgroups of a block: the
// producer's release (128 x (168 - 56)) pays for the consumers' request
// (256 x (224 - 168)) exactly; an unpaid request would wait forever
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kGatherRows = kBM * 8 / 128;  // rows a producer thread loads
constexpr long long kWatchdogCycles = 1ll << 34;  // ~9 s: trap, not hang

template <int BN>
struct Tile {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kStageBytes = kABytes + BN * kBK;
  static constexpr int kStages = kRing / kStageBytes;
  static constexpr int kInstrN = BN < 128 ? BN : 128;  // wgmma N
  static constexpr int kInstrs = BN / kInstrN;
  static constexpr int kRegs = kInstrN / 2;    // accumulators an instr
  static_assert(kStages >= 4 && kStages <= kMaxStages, "ring");
  static_assert(BN % kEpiCols == 0, "the epilogue's passes");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of the given parity; a wait that outlasts the
// watchdog traps, so a lost arrival fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWatchdogCycles) {
      __trap();
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* gmem,
                                          bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// the full barrier's arrival once this thread's cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner),
      "r"(outer)
      : "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major tile whose rows are
// 128 bytes with the 128-byte swizzle, 8-row groups 1024 bytes apart
// (the layout TMA's SWIZZLE_128B writes from a 1024-byte aligned base).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma instructions
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// How A (and B) reach the ring: kGather, A gathered by 16-byte cp.async,
// B by TMA; kDense, both by TMA (a 1 x 1 stride-1 call); kPacked, Cp = 4
// (the stem), A's taps and B's rows by 4-byte cp.async (B's rows are
// kh kw 4 bytes, not a multiple of 16, so TMA cannot read them).
enum Route { kGather = 0, kDense = 1, kPacked = 2 };

struct GemmArgs {
  const int8_t* xq;        // [B, H, W, Cp]
  const int8_t* w;         // [N, K]
  const float* w_scale;    // [N]
  const float* act_scale;  // []
  const float* bias;       // [N] or nullptr
  void* out;               // [B, N, Ho, Wo]
  int* ws;                 // [splits, N, M] partial sums, or nullptr
  int out_bf16, route;
  int vec_out;  // hw_out % 8 == 0, out 16-byte aligned: 8-pixel stores
  int H, W, Cp, N, kw, sh, sw, ph, pw, Wo, hw_out, M, K, k_tiles, k_per;
  int n_tiles, m_tiles, units;
};

// A work unit: an output tile and a slice of K. Units are numbered with the
// N tile fastest, so the blocks working at one time share their A tiles.
struct Unit {
  int n0, m0, z, kt0, nk;
};

__device__ __forceinline__ Unit unit_of(const GemmArgs& args, int u, int bn) {
  Unit w;
  const int nt = u % args.n_tiles, rest = u / args.n_tiles;
  w.n0 = nt * bn;
  w.m0 = (rest % args.m_tiles) * kBM;
  w.z = rest / args.m_tiles;
  w.kt0 = w.z * args.k_per;
  w.nk = min(args.k_tiles - w.kt0, args.k_per);
  return w;
}

// Persistent: a block per SM walks the units blockIdx.x, + gridDim.x, ...;
// the producer runs ahead into the next unit's K tiles while the consumers
// write the last unit out.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                      const __grid_constant__ CUtensorMap x_map,
                      const GemmArgs args) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ __align__(8) uint64_t empty_bar[kMaxStages];
  // the ring's base aligned to 1024 bytes, as the swizzle needs; the
  // epilogue's staging buffer after it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  int* staged = reinterpret_cast<int*>(smem_raw + (ring - raw) + kRing);

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      // kDense: one arrival with the TMA bytes; kPacked: one noinc
      // arrival from each producer thread once its cp.asyncs landed;
      // kGather: both
      mbar_init(smem_addr(&full_bar[s]), args.route == kDense    ? 1
                                         : args.route == kPacked ? 128
                                                                 : 129);
      mbar_init(smem_addr(&empty_bar[s]), 8);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (args.route == kDense && t != 0) return;
    // thread t gathers the 16-byte word j of rows t / 8 + 16 i
    const int j = t % 8;
    const int swz = ((j ^ ((t / 8) & 7)) << 4);
    const int row_k = args.kw * args.Cp;  // bytes of a window row
    int it = 0;                           // K tiles loaded so far
    for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
      const Unit w = unit_of(args, u, BN);
      // per row: its image's first pixel, and the window's corner packed
      // as two 16-bit halves (H, W < 2^15), so the producer stays in its
      // registers
      int pix[kGatherRows], corner[kGatherRows];
      if (args.route != kDense) {
#pragma unroll
        for (int i = 0; i < kGatherRows; ++i) {
          const int m = w.m0 + t / 8 + 16 * i;
          int h0 = -(1 << 14), w0 = 0;  // past M: never inside the image
          pix[i] = 0;
          if (m < args.M) {
            const int b = m / args.hw_out, p = m - b * args.hw_out;
            const int ho = p / args.Wo, wo = p - ho * args.Wo;
            pix[i] = b * args.H * args.W;
            h0 = ho * args.sh - args.ph;
            w0 = wo * args.sw - args.pw;
          }
          corner[i] = static_cast<int>((static_cast<unsigned>(h0) << 16) |
                                       (static_cast<unsigned>(w0) & 0xFFFFu));
        }
      }
      for (int i = 0; i < w.nk; ++i, ++it) {
        const int s = it % T::kStages;
        mbar_wait(smem_addr(&empty_bar[s]), ((it / T::kStages) & 1) ^ 1);
        const uint32_t bar = smem_addr(&full_bar[s]);
        const uint32_t a = ring + s * T::kStageBytes;
        const int k0 = (w.kt0 + i) * kBK;
        if (args.route == kDense) {
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load(a, &x_map, bar, k0, w.m0);
          tma_load(a + T::kABytes, &w_map, bar, k0, w.n0);
          continue;
        }
        // the packed route is compiled for 64-wide tiles only (the stem's
        // N is 64): its unrolled loads would crowd a wider tile's producer
        // out of its registers
        if (BN == 64 && args.route == kPacked) {
          // word j of a row: 4 taps of 4 bytes, each its own window pixel
          int tap_r[4], tap_s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tap = (k0 + j * 16) / 4 + e;
            tap_r[e] = tap / args.kw;
            tap_s[e] = tap - tap_r[e] * args.kw;
          }
#pragma unroll
          for (int q = 0; q < kGatherRows; ++q) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hi = (corner[q] >> 16) + tap_r[e];
              const int wi = static_cast<int16_t>(corner[q] & 0xFFFF) +
                             tap_s[e];
              const bool ok = k0 + j * 16 + 4 * e < args.K && hi >= 0 &&
                              hi < args.H && wi >= 0 && wi < args.W;
              const int8_t* src =
                  ok ? args.xq +
                           static_cast<long long>(pix[q] + hi * args.W + wi) *
                               4
                     : args.xq;
              cp_async4(a + (t / 8 + 16 * q) * kBK + swz + 4 * e, src, ok);
            }
          }
          // B: BN rows x 8 words, 4 taps of 4 bytes each
#pragma unroll
          for (int ci = t; ci < BN * 8; ci += 128) {
            const int nl = ci / 8, jb = ci % 8;
            const uint32_t dst = a + T::kABytes + nl * kBK +
                                 ((jb ^ (nl & 7)) << 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kb = k0 + jb * 16 + 4 * e;
              const bool ok = kb < args.K && w.n0 + nl < args.N;
              const int8_t* src =
                  ok ? args.w + static_cast<long long>(w.n0 + nl) * args.K + kb
                     : args.w;
              cp_async4(dst + 4 * e, src, ok);
            }
          }
          cp_async_arrive(bar);
          continue;
        }
        if (t == 0) {
          mbar_expect_tx(bar, BN * kBK);
          tma_load(a + T::kABytes, &w_map, bar, k0, w.n0);
        }
        const int k = k0 + j * 16;
        const bool k_ok = k < args.K;
        const int r = k / row_k;
        const int rem = k - r * row_k;
        const int sx = rem / args.Cp;
        const int c = rem - sx * args.Cp;
#pragma unroll
        for (int q = 0; q < kGatherRows; ++q) {
          const int hi = (corner[q] >> 16) + r;
          const int wi = static_cast<int16_t>(corner[q] & 0xFFFF) + sx;
          const bool ok = k_ok && hi >= 0 && hi < args.H && wi >= 0 &&
                          wi < args.W;
          const int8_t* src =
              ok ? args.xq +
                       static_cast<long long>(pix[q] + hi * args.W + wi) *
                           args.Cp +
                       c
                 : args.xq;
          cp_async16(a + (t / 8 + 16 * q) * kBK + swz, src, ok);
        }
        cp_async_arrive(bar);
      }
    }
    if (args.route != kDense) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int cw = wg - 1;                 // rows 64 cw .. 64 cw + 63
    const int warp = t / 32, lane = t % 32;
    const int row = cw * 64 + warp * 16 + lane / 4;
    const int ct = threadIdx.x - 128;      // 0 .. 255
    const int ml = ct % kBM;
    const float act_scale = *args.act_scale;
    int it = 0;                            // K tiles consumed so far
    for (int u = blockIdx.x; u < args.units; u += gridDim.x) {
      const Unit w = unit_of(args, u, BN);
      // this thread's column of the tile: its scale and bias, loaded while
      // the mainloop runs, staged beside the sums for the copy-out
      float col_scale = 0.f, col_bias = 0.f;
      if (ct < BN && w.n0 + ct < args.N) {
        col_scale = __fmul_rn(act_scale, args.w_scale[w.n0 + ct]);
        if (args.bias != nullptr) col_bias = args.bias[w.n0 + ct];
      }
      int acc[T::kInstrs][T::kRegs];
#pragma unroll
      for (int q = 0; q < T::kInstrs; ++q)
#pragma unroll
        for (int e = 0; e < T::kRegs; ++e) acc[q][e] = 0;

      for (int i = 0; i < w.nk; ++i, ++it) {
        const int s = it % T::kStages;
        mbar_wait(smem_addr(&full_bar[s]), (it / T::kStages) & 1);
        // cp.async wrote A through the generic proxy; wgmma reads through
        // the async one
        if (args.route != kDense) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        const uint32_t a = ring + s * T::kStageBytes + cw * 64 * kBK;
        const uint32_t b = ring + s * T::kStageBytes + T::kABytes;
#pragma unroll
        for (int q = 0; q < T::kInstrs; ++q) fence_acc(acc[q]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
          for (int q = 0; q < T::kInstrs; ++q) {
            Wgmma<T::kInstrN>::mma(
                acc[q], sw128_desc(a + kk * 32),
                sw128_desc(b + q * T::kInstrN * kBK + kk * 32));
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < T::kInstrs; ++q) fence_acc(acc[q]);
        // the previous K tile's group has finished reading: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (i > 0 && lane == 0) {
          mbar_arrive(smem_addr(&empty_bar[(it - 1) % T::kStages]));
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < T::kInstrs; ++q) fence_acc(acc[q]);
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[(it - 1) % T::kStages]));

      // epilogue, kEpiCols channels at a time: staged channel-major (a
      // row's words 128 and 129, past its 128 pixels, hold the channel's
      // scale and bias), then a warp writes 32 consecutive pixels of one
      // channel plane
      const int m = w.m0 + ml;
      const int b = m / args.hw_out, p = m - b * args.hw_out;
      const long long out_base =
          static_cast<long long>(b) * args.N * args.hw_out + p;
      int* ws = args.ws == nullptr
                    ? nullptr
                    : args.ws + static_cast<long long>(w.z) * args.N * args.M +
                          m;
      float* staged_f = reinterpret_cast<float*>(staged);
#pragma unroll
      for (int pass = 0; pass < BN / kEpiCols; ++pass) {
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // buffer free
#pragma unroll
        for (int jn = 0; jn < kEpiCols / 8; ++jn) {
          const int col0 = pass * kEpiCols + jn * 8;  // tile column
          const int q = col0 / T::kInstrN;
          const int jj = (col0 % T::kInstrN) / 8;
          const int col = jn * 8 + (lane % 4) * 2;  // staged column
          staged[col * kPitch + row] = acc[q][jj * 4 + 0];
          staged[(col + 1) * kPitch + row] = acc[q][jj * 4 + 1];
          staged[col * kPitch + row + 8] = acc[q][jj * 4 + 2];
          staged[(col + 1) * kPitch + row + 8] = acc[q][jj * 4 + 3];
        }
        if (ct / kEpiCols == pass) {
          staged_f[(ct % kEpiCols) * kPitch + kBM] = col_scale;
          staged_f[(ct % kEpiCols) * kPitch + kBM + 1] = col_bias;
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // buffer full
        if (args.vec_out && ws == nullptr) {
          // 8 consecutive pixels a thread, one 16-byte store of bf16 (two
          // of fp32): 16 threads a channel's 128 pixels
          const int pg = (ct % 16) * 8;
          const int mv = w.m0 + pg;
          if (mv < args.M) {
            const int bv = mv / args.hw_out, pv = mv - bv * args.hw_out;
            const long long base =
                static_cast<long long>(bv) * args.N * args.hw_out + pv;
#pragma unroll
            for (int k = 0; k < kEpiCols / 16; ++k) {
              const int nl = ct / 16 + 16 * k;
              const int n = w.n0 + pass * kEpiCols + nl;
              if (n < args.N) {
                const int* src = staged + nl * kPitch + pg;
                const int4 lo = *reinterpret_cast<const int4*>(src);
                const int4 hi = *reinterpret_cast<const int4*>(src + 4);
                const int v[8] = {lo.x, lo.y, lo.z, lo.w,
                                  hi.x, hi.y, hi.z, hi.w};
                const float sc = staged_f[nl * kPitch + kBM];
                const float bi = staged_f[nl * kPitch + kBM + 1];
                float y[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  y[e] = __fmul_rn(__int2float_rn(v[e]), sc);
                  if (args.bias != nullptr) y[e] = __fadd_rn(y[e], bi);
                }
                const long long at =
                    base + static_cast<long long>(n) * args.hw_out;
                if (args.out_bf16) {
                  uint4 packed;
                  unsigned* u = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const __nv_bfloat162 two =
                        __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
                    u[e] = *reinterpret_cast<const unsigned*>(&two);
                  }
                  *reinterpret_cast<uint4*>(
                      static_cast<__nv_bfloat16*>(args.out) + at) = packed;
                } else {
                  float4* dst =
                      reinterpret_cast<float4*>(static_cast<float*>(args.out) +
                                                at);
                  dst[0] = make_float4(y[0], y[1], y[2], y[3]);
                  dst[1] = make_float4(y[4], y[5], y[6], y[7]);
                }
              }
            }
          }
        } else if (m < args.M) {
#pragma unroll 8
          for (int nl = ct / kBM; nl < kEpiCols; nl += 2) {
            const int n = w.n0 + pass * kEpiCols + nl;
            if (n < args.N) {
              const int v = staged[nl * kPitch + ml];
              if (ws != nullptr) {
                ws[static_cast<long long>(n) * args.M] = v;
              } else {
                // rescale's ops in its order: act_scale * w_scale was
                // rounded once above
                float y = __fmul_rn(__int2float_rn(v),
                                    staged_f[nl * kPitch + kBM]);
                if (args.bias != nullptr) {
                  y = __fadd_rn(y, staged_f[nl * kPitch + kBM + 1]);
                }
                store_out(args.out, args.out_bf16,
                          out_base + static_cast<long long>(n) * args.hw_out,
                          y);
              }
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------ (c) split-K finish

constexpr int kFinishThreads = 256;

// grid (pixel blocks, N): a thread one output pixel of channel blockIdx.y
__global__ void __launch_bounds__(kFinishThreads)
    conv_finish_kernel(const int* __restrict__ ws, int splits, int M, int N,
                       int hw_out, const float* __restrict__ act_scale,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, void* out,
                       int out_bf16) {
  const int m = blockIdx.x * kFinishThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (m >= M) return;
  const long long mn = static_cast<long long>(M) * N;
  const int* src = ws + static_cast<long long>(n) * M + m;
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += src[s * mn];
  const int b = m / hw_out, p = m - b * hw_out;
  store_out(out, out_bf16, (static_cast<long long>(b) * N + n) * hw_out + p,
            rescale(acc, *act_scale, w_scale[n], bias, n));
}

// ------------------------------------------------ (d) grouped, direct

struct DirectArgs {
  const int8_t* xq;        // [B, H, W, Cp]
  const int8_t* w;         // [N, kh, kw, Cg]
  const float* w_scale;    // [N]
  const float* act_scale;  // []
  const float* bias;       // [N] or nullptr
  void* out;               // [B, N, Ho, Wo]
  int B, C, H, W, Cp, N, kh, kw, sh, sw, ph, pw, groups, Cg, Ho, Wo;
};

constexpr int kDirectThreads = 256;

template <typename OutT>
__global__ void __launch_bounds__(kDirectThreads)
    conv_direct_kernel(const DirectArgs args) {
  const long long total =
      static_cast<long long>(args.B) * args.N * args.Ho * args.Wo;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const int wo = static_cast<int>(i % args.Wo);
  long long rest = i / args.Wo;
  const int ho = static_cast<int>(rest % args.Ho);
  rest /= args.Ho;
  const int n = static_cast<int>(rest % args.N);
  const int b = static_cast<int>(rest / args.N);
  const int cin_g = args.C / args.groups;
  const int c_base = n / (args.N / args.groups) * cin_g;
  int acc = 0;
  for (int r = 0; r < args.kh; ++r) {
    const int hi = ho * args.sh - args.ph + r;
    if (hi < 0 || hi >= args.H) continue;
    for (int s = 0; s < args.kw; ++s) {
      const int wi = wo * args.sw - args.pw + s;
      if (wi < 0 || wi >= args.W) continue;
      const int8_t* xp =
          args.xq +
          ((static_cast<long long>(b) * args.H + hi) * args.W + wi) * args.Cp +
          c_base;
      const int8_t* wp =
          args.w + ((static_cast<long long>(n) * args.kh + r) * args.kw + s) *
                       args.Cg;
      for (int c = 0; c < cin_g; ++c) acc += int(xp[c]) * int(wp[c]);
    }
  }
  store(static_cast<OutT*>(args.out) + i,
        rescale(acc, *args.act_scale, args.w_scale[n], args.bias, n));
}

// ------------------------------------------------ host side

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that
// nothing links against libcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// A 2-D int8 tensor [outer, inner] (rows inner bytes apart) read in boxes
// of box_outer rows x 128 bytes with the 128-byte swizzle; out of bounds
// reads zeros.
cudaError_t encode_2d(CUtensorMap* map, const void* ptr, long long inner,
                      long long outer, int box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the SMs of the current device, asked once a device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& w_map, const CUtensorMap& x_map,
                         const GemmArgs& args, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  conv_wgmma_kernel<BN><<<min(args.units, sms), kThreads, kSmemBytes, st>>>(
      w_map, x_map, args);
  return cudaGetLastError();
}

// A layer's channels as the kernels pack them: 4 bytes a pixel for up to
// 4 (the stem's 3), else a multiple of 16.
int packed_channels(int c) { return c <= 4 ? 4 : (c + 15) / 16 * 16; }

}  // namespace

// The TMA descriptor of a packed weight [N, K] int8 (K = kh kw Cp, rows 16-
// byte aligned) for N tiles of `bn` rows, written to `map_out` (128 bytes of
// host memory): made once for each weight buffer by the caller.
extern "C" int odtk_conv_w8a8_weight_map(const void* w, int N, int K, int bn,
                                         void* map_out) {
  if (N < 1 || K < 16 || K % 16 != 0 ||
      (bn != 64 && bn != 128 && bn != 256) ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const cudaError_t err = encode_2d(&map, w, K, N, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memcpy(map_out, &map, sizeof(map));
  return 0;
}


// x [B, C, H, W] (in_dtype 0 fp32, 1 bf16), weight int8 [N, kh, kw, Cg]
// with Cg = packed_channels(C / groups) and, for the routes kGather and
// kDense, its TMA descriptor `w_map` (odtk_conv_w8a8_weight_map with
// `bn`), w_scale [N] and act_scale [] fp32, bias [N] fp32 or null, xq int8
// scratch [B, H, W, Cp] with Cp = packed_channels(C), ws int32 scratch
// [splits, N, B Ho Wo] when splits > 1 -> out [B, N, Ho, Wo] (out_dtype 0
// fp32, 1 bf16), all contiguous on the device of `stream`. The plan (groups
// == 1): N tile `bn`, K cut into `splits` slices of `k_per` 128-byte tiles,
// `route` a Route (kDense: 1 x 1, stride 1, no padding; kPacked: Cp = 4).
// Returns cudaGetLastError().
extern "C" int odtk_conv_w8a8(const void* x, int in_dtype, const void* w,
                              const void* w_map, const float* w_scale,
                              const float* act_scale, const float* bias,
                              void* xq, void* ws, void* out, int out_dtype,
                              int B, int C, int H, int W, int N, int kh,
                              int kw, int sh, int sw, int ph, int pw,
                              int groups, int Ho, int Wo, int bn, int splits,
                              int k_per, int route, void* stream) {
  if (groups < 1 || C < groups) return static_cast<int>(cudaErrorInvalidValue);
  const int Cp = packed_channels(C);
  const int Cg = packed_channels(C / groups);
  const long long pixels = static_cast<long long>(B) * H * W;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (C % groups != 0 || N % groups != 0 || (groups == 1 && Cg != Cp) ||
      B < 1 || Ho < 1 || Wo < 1 || pixels * Cp >= (1ll << 31) ||
      M >= (1ll << 31) || H >= (1 << 15) || W >= (1 << 15) ||
      (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  if (in_dtype == 0) {
    launch_quantize(static_cast<const float*>(x), act_scale, q,
                    static_cast<int>(pixels), C, H * W, Cp, st);
  } else {
    launch_quantize(static_cast<const __nv_bfloat16*>(x), act_scale, q,
                    static_cast<int>(pixels), C, H * W, Cp, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (groups > 1) {
    const DirectArgs args{q,   static_cast<const int8_t*>(w), w_scale,
                          act_scale, bias, out, B, C, H, W, Cp, N, kh, kw,
                          sh, sw, ph, pw, groups, Cg, Ho, Wo};
    const long long total = M * N;
    const unsigned blocks =
        static_cast<unsigned>((total + kDirectThreads - 1) / kDirectThreads);
    if (out_dtype == 0) {
      conv_direct_kernel<float><<<blocks, kDirectThreads, 0, st>>>(args);
    } else {
      conv_direct_kernel<__nv_bfloat16>
          <<<blocks, kDirectThreads, 0, st>>>(args);
    }
    return static_cast<int>(cudaGetLastError());
  }

  // the plan, checked: every K tile in exactly one non-empty slice
  const int K = kh * kw * Cp;
  const int k_tiles = (K + kBK - 1) / kBK;
  if ((bn != 64 && bn != 128 && bn != 256) || splits < 1 || k_per < 1 ||
      static_cast<long long>(splits) * k_per < k_tiles ||
      static_cast<long long>(splits - 1) * k_per >= k_tiles ||
      (splits > 1 && (ws == nullptr || N > 65535)) ||
      (route != kGather && route != kDense && route != kPacked) ||
      (route != kPacked && (w_map == nullptr || Cp == 4)) ||
      (route == kPacked && (Cp != 4 || bn != 64)) ||
      (route == kDense && (kh != 1 || kw != 1 || sh != 1 || sw != 1 ||
                           ph != 0 || pw != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  alignas(64) CUtensorMap w_tma;
  alignas(64) CUtensorMap x_tma;
  std::memset(&w_tma, 0, sizeof(w_tma));
  std::memset(&x_tma, 0, sizeof(x_tma));
  if (route != kPacked) std::memcpy(&w_tma, w_map, sizeof(w_tma));
  if (route == kDense) {  // A is xq itself: [B H W, Cp]
    err = encode_2d(&x_tma, q, Cp, pixels, kBM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (N + bn - 1) / bn;
  const int m_tiles = static_cast<int>((M + kBM - 1) / kBM);
  if (static_cast<long long>(n_tiles) * m_tiles * splits >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GemmArgs args{q, static_cast<const int8_t*>(w), w_scale,
                      act_scale, bias, out,
                      splits > 1 ? static_cast<int*>(ws) : nullptr,
                      out_dtype, route,
                      (Ho * Wo) % 8 == 0 &&
                          reinterpret_cast<uintptr_t>(out) % 16 == 0,
                      H, W, Cp, N, kw, sh, sw, ph, pw, Wo,
                      Ho * Wo, static_cast<int>(M), K, k_tiles, k_per,
                      n_tiles, m_tiles, n_tiles * m_tiles * splits};
  if (bn == 64) {
    err = launch_wgmma<64>(w_tma, x_tma, args, st);
  } else if (bn == 128) {
    err = launch_wgmma<128>(w_tma, x_tma, args, st);
  } else {
    err = launch_wgmma<256>(w_tma, x_tma, args, st);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const dim3 fgrid(static_cast<unsigned>((M + kFinishThreads - 1) /
                                         kFinishThreads),
                   N);
  conv_finish_kernel<<<fgrid, kFinishThreads, 0, st>>>(
      static_cast<const int*>(ws), splits, static_cast<int>(M), N, Ho * Wo,
      act_scale, w_scale, bias, out, out_dtype);
  return static_cast<int>(cudaGetLastError());
}
