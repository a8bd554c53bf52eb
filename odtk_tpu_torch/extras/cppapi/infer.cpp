// C++ image-inference sample (extras/cppapi/infer.cpp of the JAX package).
//
// Usage: odtk_infer engine.cppengine image.ppm [out.ppm] [detections.txt]
//
// Loads a .cppengine, letterboxes one binary PPM image into the engine's
// canvas (aspect-preserving bilinear resize, image 0 of the batch), runs
// a 100-iteration latency benchmark, prints the odtk:: kernel launches,
// draws the boxes with score >= 0.3 and writes the annotated image, and
// writes every detection of the batch at full float precision (%.9g, so
// that a reader gets the float32 values back bit for bit): one line per
// detection, "image rank score class box...", boxes in canvas pixels.

#include <chrono>
#include <cstdio>
#include <exception>
#include <string>
#include <vector>

#include "odtk_aoti.h"

namespace {

void PrintLaunches(const char* when) {
  printf("launches %s: nms=%lld nms_rotated=%lld bn_relu_pool=%lld\n", when,
         static_cast<long long>(odtk::Launches("nms")),
         static_cast<long long>(odtk::Launches("nms_rotated")),
         static_cast<long long>(odtk::Launches("bn_relu_pool")));
}

int Run(int argc, char** argv) {
  std::string engine_path = argv[1];
  std::string image_path = argv[2];
  std::string out_path = argc > 3 ? argv[3] : "detections.ppm";
  std::string det_path = argc > 4 ? argv[4] : "";

  printf("Loading engine %s...\n", engine_path.c_str());
  odtk::Engine engine(engine_path);
  const int H = engine.height(), W = engine.width();
  printf("engine: %dx%d batch=%d detections=%d input=%s\n", H, W,
         engine.max_batch(), engine.max_detections(),
         engine.input_u8() ? "u8" : "f32");

  odtk::Image image = odtk::ReadPPM(image_path);
  // aspect-preserving resize into the engine canvas
  const float ratio = std::min(static_cast<float>(W) / image.width,
                               static_cast<float>(H) / image.height);
  odtk::Image resized =
      odtk::Resize(image, static_cast<int>(image.height * ratio),
                   static_cast<int>(image.width * ratio));

  // u8 engines take raw letterboxed bytes (normalization in the graph);
  // f32 engines the normalized floats
  const size_t n = static_cast<size_t>(engine.max_batch()) * H * W * 3;
  std::vector<float> input(engine.input_u8() ? 0 : n, 0.0f);
  std::vector<uint8_t> input8(engine.input_u8() ? n : 0, 0);
  if (engine.input_u8())
    odtk::PreprocessU8(resized.rgb.data(), resized.height, resized.width,
                       input8.data(), H, W);
  else
    odtk::Preprocess(resized.rgb.data(), resized.height, resized.width,
                     input.data(), H, W);
  auto run = [&]() {
    return engine.input_u8() ? engine.Infer(input8.data())
                             : engine.Infer(input.data());
  };

  printf("Warmup...\n");
  odtk::Detections det = run();
  PrintLaunches("after 1 inference");

  const int iters = 100;
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) det = run();
  auto dt = std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                          t0).count();
  printf("Took %.3f ms per inference (incl. host I/O roundtrip)\n",
         dt / iters * 1e3);
  PrintLaunches("after 101 inferences");

  const int D = engine.max_detections(), bd = engine.box_dim();
  if (!det_path.empty()) {
    FILE* f = fopen(det_path.c_str(), "w");
    if (!f) throw std::runtime_error("cannot write " + det_path);
    for (int b = 0; b < engine.max_batch(); ++b)
      for (int i = 0; i < D; ++i) {
        const size_t k = static_cast<size_t>(b) * D + i;
        fprintf(f, "%d %d %.9g %.9g", b, i, det.scores[k], det.classes[k]);
        for (int j = 0; j < bd; ++j) fprintf(f, " %.9g", det.boxes[k * bd + j]);
        fprintf(f, "\n");
      }
    fclose(f);
    printf("wrote %s (%d x %d detections)\n", det_path.c_str(),
           engine.max_batch(), D);
  }

  const uint8_t green[3] = {0, 255, 0};
  int drawn = 0;
  for (int i = 0; i < D; ++i) {
    float score = det.scores[i];
    if (score < 0.3f) continue;
    const float* b = &det.boxes[static_cast<size_t>(i) * bd];
    float x1 = b[0] / ratio, y1 = b[1] / ratio;
    float x2 = b[2] / ratio, y2 = b[3] / ratio;
    printf("det %d: class=%d score=%.3f box=(%.1f, %.1f, %.1f, %.1f)\n", i,
           static_cast<int>(det.classes[i]), score, x1, y1, x2, y2);
    odtk::DrawBox(&image, x1, y1, x2, y2, green);
    ++drawn;
  }
  odtk::WritePPM(out_path, image);
  printf("wrote %s (%d detections >= 0.3)\n", out_path.c_str(), drawn);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: %s engine.cppengine image.ppm [out.ppm] "
            "[detections.txt]\n",
            argv[0]);
    return 1;
  }
  try {
    return Run(argc, argv);
  } catch (const c10::Error& e) {
    fprintf(stderr, "odtk_infer: %s\n", e.what_without_backtrace());
    return 1;
  } catch (const std::exception& e) {
    fprintf(stderr, "odtk_infer: %s\n", e.what());
    return 1;
  }
}
