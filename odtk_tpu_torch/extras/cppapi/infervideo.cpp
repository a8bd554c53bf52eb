// C++ video-inference sample (extras/cppapi/infervideo.cpp of the JAX
// package). Built only where CMake finds OpenCV's videoio.
//
// Usage: odtk_infervideo engine.cppengine input.mp4 output.mp4
//
// Frame loop: VideoCapture -> letterbox -> engine -> draw -> VideoWriter.

#include <cstdio>
#include <exception>
#include <string>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

#include "odtk_aoti.h"

int main(int argc, char** argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s engine.cppengine in.mp4 out.mp4\n", argv[0]);
    return 1;
  }
  try {
    odtk::Engine engine(argv[1]);
    const int H = engine.height(), W = engine.width();

    cv::VideoCapture src(argv[2]);
    if (!src.isOpened()) {
      fprintf(stderr, "cannot open %s\n", argv[2]);
      return 1;
    }
    cv::Mat frame;
    src >> frame;
    if (frame.empty()) return 1;

    cv::VideoWriter sink(argv[3],
                         cv::VideoWriter::fourcc('m', 'p', '4', 'v'),
                         src.get(cv::CAP_PROP_FPS),
                         cv::Size(frame.cols, frame.rows));
    const float ratio = std::min(static_cast<float>(W) / frame.cols,
                                 static_cast<float>(H) / frame.rows);
    const size_t n = static_cast<size_t>(engine.max_batch()) * H * W * 3;
    std::vector<float> input(engine.input_u8() ? 0 : n, 0.0f);
    std::vector<uint8_t> input8(engine.input_u8() ? n : 0, 0);

    int frames = 0;
    while (!frame.empty()) {
      cv::Mat resized, rgb;
      cv::resize(frame, resized,
                 cv::Size(frame.cols * ratio, frame.rows * ratio));
      cv::cvtColor(resized, rgb, cv::COLOR_BGR2RGB);
      odtk::Detections det;
      if (engine.input_u8()) {
        odtk::PreprocessU8(rgb.data, rgb.rows, rgb.cols, input8.data(), H,
                           W);
        det = engine.Infer(input8.data());
      } else {
        odtk::Preprocess(rgb.data, rgb.rows, rgb.cols, input.data(), H, W);
        det = engine.Infer(input.data());
      }
      for (int i = 0; i < engine.max_detections(); ++i) {
        if (det.scores[i] < 0.3f) continue;
        const float* b = &det.boxes[static_cast<size_t>(i) * engine.box_dim()];
        cv::rectangle(frame, cv::Point(b[0] / ratio, b[1] / ratio),
                      cv::Point(b[2] / ratio, b[3] / ratio),
                      cv::Scalar(0, 255, 0), 2);
      }
      sink << frame;
      ++frames;
      src >> frame;
    }
    printf("processed %d frames -> %s\n", frames, argv[3]);
  } catch (const c10::Error& e) {
    fprintf(stderr, "odtk_infervideo: %s\n", e.what_without_backtrace());
    return 1;
  } catch (const std::exception& e) {
    fprintf(stderr, "odtk_infervideo: %s\n", e.what());
    return 1;
  }
  return 0;
}
