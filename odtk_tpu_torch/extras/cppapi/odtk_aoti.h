// odtk-tpu-torch C++ inference runtime over AOTInductor packages.
//
// The counterpart of extras/cppapi/odtk_pjrt.h (the JAX package's PJRT
// runtime) and of the original's odtk::Engine: load a .cppengine written
// by odtk_tpu_torch.export.export_cpp_engine (an AOTInductor package with
// the weights baked in, compiled for the device it was exported on) and
// run batched inference. The graph holds decode and NMS, so the outputs
// are final: scores [batch, D], boxes [batch, D * box_dim], classes
// [batch, D]. The hand-written kernels run as the odtk:: operators that
// odtk_ops.cpp registers; link that library.
//
// Also: the ImageNet preprocessing of the samples (Preprocess,
// PreprocessU8), a bilinear resize, and a binary PPM (P6) reader and
// writer, so that the samples need no image library.
//
// Header-only; link libtorch and odtk_ops.

#ifndef ODTK_AOTI_H_
#define ODTK_AOTI_H_

#include <ATen/core/Tensor.h>
#include <ATen/ops/from_blob.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace odtk {

// Defined in odtk_ops.cpp: the launches of odtk::<op> ("nms",
// "nms_rotated", "bn_relu_pool") in this process, and its registered
// schema ("" if none).
int64_t Launches(const std::string& op);
std::string Schema(const std::string& op);

struct Detections {
  std::vector<float> scores;   // [batch * detections]
  std::vector<float> boxes;    // [batch * detections * box_dim]
  std::vector<float> classes;  // [batch * detections]
};

class Engine {
 public:
  explicit Engine(const std::string& path)
      : loader_(path), meta_(loader_.get_metadata()) {
    height_ = Int("height");
    width_ = Int("width");
    batch_ = Int("batch");
    detections_ = Int("detections");
    box_dim_ = Int("box_dim");
    stride_ = Int("stride");
    input_u8_ = Field("input") == "u8";
    device_ = Field("device") == "cuda" ? at::Device(at::kCUDA, 0)
                                        : at::Device(at::kCPU);
  }

  int height() const { return height_; }
  int width() const { return width_; }
  int max_batch() const { return batch_; }
  int max_detections() const { return detections_; }
  int box_dim() const { return box_dim_; }
  int stride() const { return stride_; }
  bool input_u8() const { return input_u8_; }
  const std::unordered_map<std::string, std::string>& meta() const {
    return meta_;
  }

  // input: float32 NHWC [batch, height, width, 3], preprocessed (RGB/255
  // normalized by the ImageNet mean/std, zero-padded).
  Detections Infer(const float* input) {
    if (input_u8_)
      throw std::runtime_error("engine takes u8 input (input_u8())");
    return Run(input, at::kFloat);
  }

  // input: raw RGB uint8 NHWC, letterboxed (black-padded); engines
  // exported with --input-format u8 normalize in the graph.
  Detections Infer(const uint8_t* input) {
    if (!input_u8_)
      throw std::runtime_error("engine takes f32 input (input_u8())");
    return Run(input, at::kByte);
  }

 private:
  std::string Field(const std::string& key) const {
    auto it = meta_.find(key);
    if (it == meta_.end())
      throw std::runtime_error("package metadata has no " + key +
                               ": not an odtk-tpu-torch .cppengine");
    return it->second;
  }
  int Int(const std::string& key) const { return std::stoi(Field(key)); }

  Detections Run(const void* input, at::ScalarType type) {
    at::Tensor host = at::from_blob(const_cast<void*>(input),
                                    {batch_, height_, width_, 3},
                                    at::TensorOptions().dtype(type));
    std::vector<at::Tensor> outs = loader_.run({host.to(device_)});
    if (outs.size() != 3)
      throw std::runtime_error("package returned " +
                               std::to_string(outs.size()) +
                               " outputs, not 3");
    Detections det;
    Fetch(outs[0], &det.scores, static_cast<size_t>(batch_) * detections_);
    Fetch(outs[1], &det.boxes,
          static_cast<size_t>(batch_) * detections_ * box_dim_);
    Fetch(outs[2], &det.classes, static_cast<size_t>(batch_) * detections_);
    return det;
  }

  static void Fetch(const at::Tensor& t, std::vector<float>* dst,
                    size_t n) {
    at::Tensor c = t.to(at::kCPU, at::kFloat).contiguous();
    if (static_cast<size_t>(c.numel()) != n)
      throw std::runtime_error("output of " + std::to_string(c.numel()) +
                               " values, expected " + std::to_string(n));
    dst->assign(c.data_ptr<float>(), c.data_ptr<float>() + n);
  }

  torch::inductor::AOTIModelPackageLoader loader_;
  std::unordered_map<std::string, std::string> meta_;
  int height_, width_, batch_, detections_, box_dim_, stride_;
  bool input_u8_ = false;
  at::Device device_ = at::Device(at::kCPU);
};

// ImageNet preprocessing shared by the samples (odtk/data.py:25-26).
inline void Preprocess(const uint8_t* rgb, int h, int w, float* out,
                       int out_h, int out_w) {
  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float stdv[3] = {0.229f, 0.224f, 0.225f};
  std::memset(out, 0, sizeof(float) * out_h * out_w * 3);
  for (int y = 0; y < h && y < out_h; ++y)
    for (int x = 0; x < w && x < out_w; ++x)
      for (int c = 0; c < 3; ++c)
        out[(y * out_w + x) * 3 + c] =
            (rgb[(y * w + x) * 3 + c] / 255.0f - mean[c]) / stdv[c];
}

// u8-engine preprocessing: plain letterbox byte paste (normalization
// runs in the graph; padding stays black).
inline void PreprocessU8(const uint8_t* rgb, int h, int w, uint8_t* out,
                         int out_h, int out_w) {
  std::memset(out, 0, static_cast<size_t>(out_h) * out_w * 3);
  for (int y = 0; y < h && y < out_h; ++y)
    std::memcpy(out + static_cast<size_t>(y) * out_w * 3,
                rgb + static_cast<size_t>(y) * w * 3,
                static_cast<size_t>(w < out_w ? w : out_w) * 3);
}

// An 8-bit RGB image, rows top to bottom.
struct Image {
  int height = 0, width = 0;
  std::vector<uint8_t> rgb;  // [height * width * 3]
};

// Bilinear resize with half-pixel centres (OpenCV's INTER_LINEAR for
// upscaling); a resize to the same size is a copy.
inline Image Resize(const Image& src, int out_h, int out_w) {
  if (out_h == src.height && out_w == src.width) return src;
  Image dst;
  dst.height = out_h;
  dst.width = out_w;
  dst.rgb.resize(static_cast<size_t>(out_h) * out_w * 3);
  const float sy = static_cast<float>(src.height) / out_h;
  const float sx = static_cast<float>(src.width) / out_w;
  for (int y = 0; y < out_h; ++y) {
    float fy = std::max(0.0f, (y + 0.5f) * sy - 0.5f);
    int y0 = std::min(static_cast<int>(fy), src.height - 1);
    int y1 = std::min(y0 + 1, src.height - 1);
    float wy = fy - y0;
    for (int x = 0; x < out_w; ++x) {
      float fx = std::max(0.0f, (x + 0.5f) * sx - 0.5f);
      int x0 = std::min(static_cast<int>(fx), src.width - 1);
      int x1 = std::min(x0 + 1, src.width - 1);
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        auto at = [&](int yy, int xx) {
          return static_cast<float>(
              src.rgb[(static_cast<size_t>(yy) * src.width + xx) * 3 + c]);
        };
        float v = (1 - wy) * ((1 - wx) * at(y0, x0) + wx * at(y0, x1)) +
                  wy * ((1 - wx) * at(y1, x0) + wx * at(y1, x1));
        dst.rgb[(static_cast<size_t>(y) * out_w + x) * 3 + c] =
            static_cast<uint8_t>(std::lround(std::min(255.0f, v)));
      }
    }
  }
  return dst;
}

// Binary PPM (P6, maxval 255) reader; throws on anything else.
inline Image ReadPPM(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  auto token = [&]() {
    std::string t;
    while (f && t.empty()) {
      int ch = f.get();
      if (ch == '#') {
        std::string line;
        std::getline(f, line);
      } else if (ch != EOF && !std::isspace(ch)) {
        t.push_back(static_cast<char>(ch));
        while (f && !std::isspace(f.peek()) && f.peek() != EOF)
          t.push_back(static_cast<char>(f.get()));
      } else if (ch == EOF) {
        break;
      }
    }
    return t;
  };
  if (token() != "P6") throw std::runtime_error(path + ": not a P6 PPM");
  Image im;
  im.width = std::stoi(token());
  im.height = std::stoi(token());
  if (token() != "255")
    throw std::runtime_error(path + ": maxval must be 255");
  f.get();  // the single whitespace byte before the pixels
  im.rgb.resize(static_cast<size_t>(im.height) * im.width * 3);
  f.read(reinterpret_cast<char*>(im.rgb.data()), im.rgb.size());
  if (static_cast<size_t>(f.gcount()) != im.rgb.size())
    throw std::runtime_error(path + ": truncated PPM");
  return im;
}

inline void WritePPM(const std::string& path, const Image& im) {
  std::ofstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot write " + path);
  f << "P6\n" << im.width << " " << im.height << "\n255\n";
  f.write(reinterpret_cast<const char*>(im.rgb.data()), im.rgb.size());
}

// A rectangle outline 2 pixels thick, clipped to the image.
inline void DrawBox(Image* im, float x1, float y1, float x2, float y2,
                    const uint8_t color[3]) {
  const int thickness = 2;
  int l = static_cast<int>(x1), t = static_cast<int>(y1);
  int r = static_cast<int>(x2), b = static_cast<int>(y2);
  for (int y = t; y <= b; ++y)
    for (int x = l; x <= r; ++x) {
      bool edge = y - t < thickness || b - y < thickness ||
                  x - l < thickness || r - x < thickness;
      if (!edge || y < 0 || x < 0 || y >= im->height || x >= im->width)
        continue;
      std::memcpy(&im->rgb[(static_cast<size_t>(y) * im->width + x) * 3],
                  color, 3);
    }
}

}  // namespace odtk

#endif  // ODTK_AOTI_H_
