// C++ export sample (extras/cppapi/export.cpp of the JAX package).
//
// Engines are written from Python (odtk_tpu_torch.export.export_cpp_engine,
// or `odtk-tpu-torch export model.pth out.cppengine`): lowering needs the
// tracer. This sample covers the other half of the original's export.cpp:
// it loads an engine and prints its deployment contract, the check a
// deployment pipeline runs before shipping one.
//
// Usage: odtk_export engine.cppengine
//        odtk_export --schemas     (the odtk:: operators this process has)

#include <cstdio>
#include <exception>
#include <map>
#include <string>

#include "odtk_aoti.h"

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s engine.cppengine | --schemas\n", argv[0]);
    fprintf(stderr,
            "create engines with: odtk-tpu-torch export model.pth "
            "out.cppengine (or odtk_tpu_torch.export.export_cpp_engine)\n");
    return 1;
  }
  if (std::string(argv[1]) == "--schemas") {
    for (const char* op : {"nms", "nms_rotated", "bn_relu_pool"})
      printf("%s\n", odtk::Schema(op).c_str());
    return 0;
  }
  try {
    odtk::Engine engine(argv[1]);
    // sorted, AOTInductor's own keys included
    std::map<std::string, std::string> meta(engine.meta().begin(),
                                            engine.meta().end());
    printf("engine:     %s\n", argv[1]);
    for (const auto& kv : meta)
      printf("meta:       %s = %s\n", kv.first.c_str(), kv.second.c_str());
    if (engine.input_u8())
      printf("input:      uint8 NHWC [%d, %d, %d, 3], raw RGB, letterboxed "
             "(normalized in the graph)\n",
             engine.max_batch(), engine.height(), engine.width());
    else
      printf("input:      float32 NHWC [%d, %d, %d, 3], RGB/255 "
             "ImageNet-normalized\n",
             engine.max_batch(), engine.height(), engine.width());
    printf("outputs:    scores [%d, %d], boxes [%d, %d x %d], classes "
           "[%d, %d]\n",
           engine.max_batch(), engine.max_detections(), engine.max_batch(),
           engine.max_detections(), engine.box_dim(), engine.max_batch(),
           engine.max_detections());
  } catch (const c10::Error& e) {
    fprintf(stderr, "%s: %s\n", argv[1], e.what_without_backtrace());
    return 1;
  } catch (const std::exception& e) {
    fprintf(stderr, "%s: %s\n", argv[1], e.what());
    return 1;
  }
  return 0;
}
