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
// 3 x 3 conv over 2048 channels: |acc| <= 18432 * 127^2 < 2^31), the
// quotient and the epilogue are IEEE fp32 with explicit round-to-nearest
// intrinsics (no FMA contraction), so the result equals the plain version
// (ops/kernels/conv_w8a8.py:conv_w8a8_plain) bit for bit.
//
// Three kernels, launched one after the other on the caller's stream:
//   (a) quantize_nhwc: x NCHW (fp32 or bf16) -> xq int8 NHWC with the
//       channels padded with zeros to Cp, a multiple of 16, so that 16
//       consecutive values of the contraction are one 16-byte word. An
//       elementwise pass: a thread quantizes 16 channels of one pixel,
//       consecutive threads take consecutive pixels (coalesced reads of
//       each channel plane).
//   (b) conv_igemm (groups == 1): an implicit GEMM, M = B Ho Wo output
//       pixels, N = Cout, K = kh kw Cp in (kh, kw, c) order, B operand the
//       weight as the module stores it, [Cout, kh, kw, Cp] int8. A block of
//       256 threads computes a 128 x BN tile (BN = 64 for Cout <= 64, else
//       128) over K in steps of 64: each thread gathers 16-byte words of A
//       (one output pixel's window row, padding and K's tail masked by a
//       zero-filling cp.async) and of B into a 3-stage ring in shared
//       memory; eight warps run int8 tensor-core products
//       (mma.sync.m16n8k32.s32.s8.s8.s32) into int32 registers. Rows of the
//       ring are 80 bytes apart, so the fragment loads are free of bank
//       conflicts. The epilogue applies the rescale and bias and stores NCHW
//       in the output dtype.
//   (c) conv_direct (groups > 1, the depthwise convs of MobileNetV2FPN):
//       one thread an output, an int32 dot over kh kw cin/groups; tensor-core
//       tiles would be nearly empty at K = 9.
//
// Bound on the card: at ResNet50FPN's shapes most convs are bound by the
// int8 operations (2 M N K over 1979 TOP/s), the 1 x 1 convs of layer1 and
// the stem by bytes (x read, y written). This first version aims at being
// right: mma.sync, not wgmma with TMA, and the quantize pass writes and the
// GEMM reads an int8 copy of x that a fused A load would not need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_nhwc_kernel(const T* __restrict__ x,
                         const float* __restrict__ act_scale,
                         int8_t* __restrict__ xq, long long pixels, int C,
                         int hw, int Cp) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const int groups = Cp / 16;
  if (i >= pixels * groups) return;
  const long long pix = i % pixels;  // consecutive threads: next pixel
  const int c0 = static_cast<int>(i / pixels) * 16;
  const long long b = pix / hw;
  const int p = static_cast<int>(pix - b * hw);
  const float s = *act_scale;
  const T* src = x + (b * C + c0) * hw + p;
  alignas(16) int8_t q[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    q[j] = c0 + j < C ? static_cast<int8_t>(
                            quantize(to_float(src[(long long)j * hw]), s))
                      : int8_t(0);
  }
  *reinterpret_cast<int4*>(xq + pix * Cp + c0) =
      *reinterpret_cast<const int4*>(q);
}

struct ConvArgs {
  const int8_t* xq;        // [B, H, W, Cp]
  const int8_t* w;         // [N, kh, kw, Cg], Cg = Cp for groups == 1
  const float* w_scale;    // [N]
  const float* act_scale;  // []
  const float* bias;       // [N] or nullptr
  void* out;               // [B, N, Ho, Wo]
  int B, C, H, W, Cp, N, kh, kw, sh, sw, ph, pw, groups, Cg, Ho, Wo;
};

// ------------------------------------------------ (b) implicit GEMM

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels a block
constexpr int kBK = 64;        // contraction bytes a stage
constexpr int kStages = 3;
constexpr int kRow = kBK + 16;  // shared-memory row pitch, bytes
constexpr int kChunks = kBK / 16;  // 16-byte words a row of a stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM + BN) * kRow;
}

template <typename OutT, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_igemm_kernel(const ConvArgs args) {
  constexpr int kWarpsN = BN / 32;          // a warp: 32 output channels
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM;        // a warp's output pixels
  constexpr int kMT = kWM / 16;             // m16 tiles a warp
  constexpr int kNT = 4;                    // n8 tiles a warp
  constexpr int kAIters = kBM * kChunks / kThreads;
  constexpr int kBIters = BN * kChunks / kThreads;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                             // [kStages][kBM][kRow]
  int8_t* Bs = smem + kStages * kBM * kRow;      // [kStages][BN][kRow]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int M = args.B * args.Ho * args.Wo;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int hw_out = args.Ho * args.Wo;
  const int K = args.kh * args.kw * args.Cp;
  const int row_k = args.kw * args.Cp;   // contraction bytes a window row
  const int kc = tid % kChunks;          // this thread's word of a row

  // The output pixels whose A words this thread loads: their image's
  // offset and the window's top-left corner (invalid rows: far outside).
  long long a_base[kAIters];
  int a_h[kAIters], a_w[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const int m = m0 + (tid + i * kThreads) / kChunks;
    if (m < M) {
      const int b = m / hw_out, p = m - b * hw_out;
      const int ho = p / args.Wo, wo = p - ho * args.Wo;
      a_base[i] = static_cast<long long>(b) * args.H * args.W * args.Cp;
      a_h[i] = ho * args.sh - args.ph;
      a_w[i] = wo * args.sw - args.pw;
    } else {
      a_base[i] = 0;
      a_h[i] = -(1 << 28);
      a_w[i] = 0;
    }
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK + kc * 16;
    const bool k_ok = k0 < K;
    const int r = k0 / row_k;
    const int rem = k0 - r * row_k;
    const int s = rem / args.Cp;
    const int c0 = rem - s * args.Cp;
    int8_t* as = As + stage * kBM * kRow;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int row = (tid + i * kThreads) / kChunks;
      const int hi = a_h[i] + r, wi = a_w[i] + s;
      const bool ok = k_ok && hi >= 0 && hi < args.H && wi >= 0 &&
                      wi < args.W;
      const int8_t* src =
          ok ? args.xq + a_base[i] +
                   (static_cast<long long>(hi) * args.W + wi) * args.Cp + c0
             : args.xq;
      cp_async16(as + row * kRow + kc * 16, src, ok);
    }
    int8_t* bs = Bs + stage * BN * kRow;
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int row = (tid + i * kThreads) / kChunks;
      const int n = n0 + row;
      const bool ok = k_ok && n < args.N;
      const int8_t* src =
          ok ? args.w + static_cast<long long>(n) * K + k0 : args.w;
      cp_async16(bs + row * kRow + kc * 16, src, ok);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* as = As + (kt % kStages) * kBM * kRow;
    const int8_t* bs = Bs + (kt % kStages) * BN * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* p = as + (warp_m * kWM + i * 16 + g) * kRow + ks + t * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kRow);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = bs + (warp_n * 32 + j * 8 + g) * kRow + ks + t * 4;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: c[0], c[1] at (row g, cols 2t, 2t + 1) of the m16 x n8 tile,
  // c[2], c[3] at row g + 8.
  const float act_scale = *args.act_scale;
  OutT* out = static_cast<OutT*>(args.out);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * kWM + i * 16 + g + half * 8;
      if (m >= M) continue;
      const int b = m / hw_out, p = m - b * hw_out;
      const long long base = static_cast<long long>(b) * args.N * hw_out + p;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + warp_n * 32 + j * 8 + 2 * t + e;
          if (n >= args.N) continue;
          store(out + base + static_cast<long long>(n) * hw_out,
                rescale(acc[i][j][half * 2 + e], act_scale, args.w_scale[n],
                        args.bias, n));
        }
      }
    }
  }
}

// ------------------------------------------------ (c) grouped, direct

constexpr int kDirectThreads = 256;

template <typename OutT>
__global__ void __launch_bounds__(kDirectThreads)
    conv_direct_kernel(const ConvArgs args) {
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

template <typename OutT, int BN>
cudaError_t launch_igemm(const ConvArgs& args, cudaStream_t st) {
  constexpr int bytes = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      conv_igemm_kernel<OutT, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int M = args.B * args.Ho * args.Wo;
  const dim3 grid((M + kBM - 1) / kBM, (args.N + BN - 1) / BN);
  conv_igemm_kernel<OutT, BN><<<grid, kThreads, bytes, st>>>(args);
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch_conv(const ConvArgs& args, cudaStream_t st) {
  if (args.groups == 1) {
    return args.N <= 64 ? launch_igemm<OutT, 64>(args, st)
                        : launch_igemm<OutT, 128>(args, st);
  }
  const long long total =
      static_cast<long long>(args.B) * args.N * args.Ho * args.Wo;
  conv_direct_kernel<OutT>
      <<<static_cast<unsigned>((total + kDirectThreads - 1) / kDirectThreads),
         kDirectThreads, 0, st>>>(args);
  return cudaSuccess;
}

}  // namespace

// x [B, C, H, W] (in_dtype 0 fp32, 1 bf16), weight int8 [N, kh, kw, Cg]
// with Cg = roundup(C / groups, 16), w_scale [N] and act_scale [] fp32,
// bias [N] fp32 or null, xq int8 scratch [B, H, W, Cp] with Cp =
// roundup(C, 16) -> out [B, N, Ho, Wo] (out_dtype 0 fp32, 1 bf16), all
// contiguous on the device of `stream`. Returns cudaGetLastError().
extern "C" int odtk_conv_w8a8(const void* x, int in_dtype, const void* w,
                              const float* w_scale, const float* act_scale,
                              const float* bias, void* xq, void* out,
                              int out_dtype, int B, int C, int H, int W,
                              int N, int kh, int kw, int sh, int sw, int ph,
                              int pw, int groups, int Ho, int Wo,
                              void* stream) {
  const int Cp = (C + 15) / 16 * 16;
  const int Cg = (C / groups + 15) / 16 * 16;
  if (groups < 1 || C % groups != 0 || N % groups != 0 ||
      (groups == 1 && Cg != Cp) || B < 1 || Ho < 1 || Wo < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  const long long pixels = static_cast<long long>(B) * H * W;
  const unsigned qblocks = static_cast<unsigned>(
      (pixels * (Cp / 16) + kQuantThreads - 1) / kQuantThreads);
  if (in_dtype == 0) {
    quantize_nhwc_kernel<float><<<qblocks, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), act_scale, q, pixels, C, H * W, Cp);
  } else if (in_dtype == 1) {
    quantize_nhwc_kernel<__nv_bfloat16><<<qblocks, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), act_scale, q, pixels, C, H * W,
        Cp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const ConvArgs args{q,  static_cast<const int8_t*>(w), w_scale, act_scale,
                      bias, out, B, C, H, W, Cp, N, kh, kw, sh, sw, ph, pw,
                      groups, Cg, Ho, Wo};
  if (out_dtype == 0) {
    err = launch_conv<float>(args, st);
  } else if (out_dtype == 1) {
    err = launch_conv<__nv_bfloat16>(args, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
