// The odtk:: operators for C++ processes: the schemas of nms, nms_rotated
// and bn_relu_pool, and their CUDA implementations.
//
// An AOTInductor package (odtk_tpu_torch/export.py:export_cpp_engine)
// keeps the hand-written kernels as calls of these operators. A Python
// process registers them from odtk_tpu_torch/ops/kernels/ (nms.py,
// nms_rotated.py, stem.py); a C++ process that loads a package links this
// library instead. Each CUDA implementation repeats its Python wrapper's
// checks, output allocation and scratch size, and launches the kernel
// through the same C entry point of the kernel library that
// odtk_tpu_torch/ops/kernels/_build.py builds from odtk_tpu_torch/csrc/
// (odtk_nms, odtk_nms_rotated, odtk_stem_pool), on the current CUDA
// stream. There is no CPU implementation: a CPU package run from C++
// raises, and nothing falls back to a plain version.
//
// Built without ODTK_WITH_CUDA (no kernel library, as with a CPU build of
// torch) it holds the schemas alone: enough to load a package and read its
// metadata.
//
// Never load this library into a Python process that imported
// odtk_tpu_torch: the two registrations of the odtk namespace collide.

#include <ATen/core/Tensor.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/library.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <string>
#include <tuple>

#ifdef ODTK_WITH_CUDA
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
int odtk_nms(const float* scores, const float* boxes, const float* classes,
             int batch, int n, int ndet, float thr, void* scratch,
             float* out_s, float* out_b, float* out_c, void* stream);
int odtk_nms_rotated(const float* scores, const float* boxes,
                     const float* classes, int batch, int n, int ndet,
                     float thr, void* scratch, float* out_s, float* out_b,
                     float* out_c, void* stream);
int odtk_stem_pool(const void* y, const float* scale, const float* shift,
                   void* out, int dtype, int B, int C, int hc, int wc, int hp,
                   int wp, void* stream);
}
#endif

namespace odtk {

// The operators, in the order of their launch counters.
constexpr std::array<const char*, 3> kOps = {"nms", "nms_rotated",
                                             "bn_relu_pool"};
std::array<std::atomic<int64_t>, 3> g_launches{};

// The launches of operator ``op`` (a name of kOps) since the process
// started, or -1 for another name.
int64_t Launches(const std::string& op) {
  for (size_t i = 0; i < kOps.size(); ++i) {
    if (op == kOps[i]) return g_launches[i].load();
  }
  return -1;
}

// The registered schema of odtk::<op>, as Python's
// str(torch.ops.odtk.<op>.default._schema) prints it, or "" if none is.
std::string Schema(const std::string& op) {
  auto handle =
      c10::Dispatcher::singleton().findSchema({"odtk::" + op, ""});
  return handle ? c10::toString(handle->schema()) : std::string();
}

#ifdef ODTK_WITH_CUDA
namespace {

constexpr int64_t kMaxCandidates = 16384;  // the scan's bitset of ranks

void* Stream(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

// The greedy NMS kernels' shared body (ops/kernels/nms.py:_nms_cuda and
// nms_rotated.py:_nms_rotated_cuda): checks, outputs, the scan's scratch
// (nms.py:scan_scratch), one call of ``entry``.
template <typename Entry>
std::tuple<at::Tensor, at::Tensor, at::Tensor> NmsCuda(
    const char* name, Entry entry, int64_t box_dim, int counter,
    const at::Tensor& scores, const at::Tensor& boxes,
    const at::Tensor& classes, double nms_thresh, int64_t ndet) {
  TORCH_CHECK(scores.dim() == 2, name, ": scores must be [B, N], got ",
              scores.sizes());
  const int64_t b = scores.size(0), n = scores.size(1);
  TORCH_CHECK(boxes.dim() == 3 && boxes.size(0) == b && boxes.size(1) == n &&
                  boxes.size(2) == box_dim && classes.dim() == 2 &&
                  classes.size(0) == b && classes.size(1) == n,
              name, ": shapes ", scores.sizes(), ", ", boxes.sizes(), ", ",
              classes.sizes());
  TORCH_CHECK(n <= kMaxCandidates, name, ": ", n,
              " candidates, the kernel takes at most ", kMaxCandidates);
  TORCH_CHECK(scores.is_cuda() && boxes.device() == scores.device() &&
                  classes.device() == scores.device(),
              name, ": inputs must be on one CUDA device");
  TORCH_CHECK(ndet >= 0, name, ": ndetections must be >= 0");
  c10::cuda::CUDAGuard guard(scores.device());
  const at::Tensor s = scores.to(at::kFloat).contiguous();
  const at::Tensor bx = boxes.to(at::kFloat).contiguous();
  const at::Tensor c = classes.to(at::kFloat).contiguous();
  at::Tensor out_s = at::empty({b, ndet}, s.options());
  at::Tensor out_b = at::empty({b, ndet, box_dim}, s.options());
  at::Tensor out_c = at::empty({b, ndet}, s.options());
  if (b == 0 || ndet == 0) return {out_s, out_b, out_c};
  if (n == 0) return {out_s.zero_(), out_b.zero_(), out_c.zero_()};
  const int64_t words = (n + 63) / 64;
  at::Tensor scratch = at::empty({b * (n * words * 2 + 2 * n + 2 + ndet)},
                                 s.options().dtype(at::kInt));
  const int rc = entry(
      s.data_ptr<float>(), bx.data_ptr<float>(), c.data_ptr<float>(),
      static_cast<int>(b), static_cast<int>(n), static_cast<int>(ndet),
      static_cast<float>(nms_thresh), scratch.data_ptr(),
      out_s.data_ptr<float>(), out_b.data_ptr<float>(),
      out_c.data_ptr<float>(), Stream(s));
  TORCH_CHECK(rc == 0, name, ": CUDA error ", rc);
  ++g_launches[counter];
  return {out_s, out_b, out_c};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> NmsImpl(
    const at::Tensor& scores, const at::Tensor& boxes,
    const at::Tensor& classes, double nms_thresh, c10::SymInt ndetections) {
  return NmsCuda("odtk_nms", odtk_nms, 4, 0, scores, boxes, classes,
                 nms_thresh, ndetections.expect_int());
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> NmsRotatedImpl(
    const at::Tensor& scores, const at::Tensor& boxes,
    const at::Tensor& classes, double nms_thresh, c10::SymInt ndetections) {
  return NmsCuda("odtk_nms_rotated", odtk_nms_rotated, 6, 1, scores, boxes,
                 classes, nms_thresh, ndetections.expect_int());
}

// ops/kernels/stem.py:_check and _bn_relu_pool_cuda.
at::Tensor BnReluPoolImpl(const at::Tensor& y, const at::Tensor& scale_in,
                          const at::Tensor& shift_in) {
  TORCH_CHECK(y.is_cuda(), "bn_relu_pool: no kernel for device ",
              y.device());
  int dtype = -1;
  if (y.scalar_type() == at::kFloat) dtype = 0;
  if (y.scalar_type() == at::kBFloat16) dtype = 1;
  TORCH_CHECK(dtype >= 0, "bn_relu_pool: dtype ", y.scalar_type(),
              " not supported");
  TORCH_CHECK(y.dim() == 4 && y.is_contiguous(),
              "bn_relu_pool: y must be a contiguous NCHW tensor, got shape ",
              y.sizes(), " strides ", y.strides());
  const int64_t b = y.size(0), c = y.size(1), hc = y.size(2), wc = y.size(3);
  c10::cuda::CUDAGuard guard(y.device());
  const at::Tensor scale = scale_in.to(y.device(), at::kFloat).contiguous();
  const at::Tensor shift = shift_in.to(y.device(), at::kFloat).contiguous();
  TORCH_CHECK(scale.dim() == 1 && scale.size(0) == c && shift.dim() == 1 &&
                  shift.size(0) == c,
              "bn_relu_pool: scale/shift must be [", c, "]");
  const int64_t hp = (hc - 1) / 2 + 1, wp = (wc - 1) / 2 + 1;
  at::Tensor out = at::empty({b, c, hp, wp}, y.options());
  if (out.numel() == 0) return out;
  const int rc = odtk_stem_pool(
      y.data_ptr(), scale.data_ptr<float>(), shift.data_ptr<float>(),
      out.data_ptr(), dtype, static_cast<int>(b), static_cast<int>(c),
      static_cast<int>(hc), static_cast<int>(wc), static_cast<int>(hp),
      static_cast<int>(wp), Stream(y));
  TORCH_CHECK(rc == 0, "odtk_stem_pool: CUDA error ", rc);
  ++g_launches[2];
  return out;
}

}  // namespace
#endif

}  // namespace odtk

// The schemas, copied from str(torch.ops.odtk.<op>.default._schema) of the
// Python registration; tests/test_torch_cppapi.py holds them equal.
TORCH_LIBRARY(odtk, m) {
  m.def(
      "odtk::nms(Tensor scores, Tensor boxes, Tensor classes, "
      "float nms_thresh, SymInt ndetections) -> (Tensor, Tensor, Tensor)");
  m.def(
      "odtk::nms_rotated(Tensor scores, Tensor boxes, Tensor classes, "
      "float nms_thresh, SymInt ndetections) -> (Tensor, Tensor, Tensor)");
  m.def("odtk::bn_relu_pool(Tensor y, Tensor scale, Tensor shift) -> Tensor");
}

#ifdef ODTK_WITH_CUDA
TORCH_LIBRARY_IMPL(odtk, CUDA, m) {
  m.impl("nms", &odtk::NmsImpl);
  m.impl("nms_rotated", &odtk::NmsRotatedImpl);
  m.impl("bn_relu_pool", &odtk::BnReluPoolImpl);
}
#endif
