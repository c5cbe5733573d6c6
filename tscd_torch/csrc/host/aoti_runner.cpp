// Standalone C++ runner of an AOTInductor package exported by
// `python -m tscd_torch.tools.export --raw` (counterpart of
// tscd_tpu/native/pjrt_runner.cpp, with torch::inductor's package loader
// in place of a PJRT plugin): loads the package and the library of the
// hand kernels' C++ ops (csrc/torch_ops.cpp, which the package's tscd::*
// calls need), runs the raw YOLOX forward on the card, then decodes and
// NMSes the raw head output with the same native code the Python side
// binds (yolox_deploy.cpp yolox_decode_nms).
//
// Build (tscd_torch/utils/native.py:aoti_runner does this):
//   g++ -O3 -std=c++17 aoti_runner.cpp yolox_deploy.cpp -I<torch includes>
//       -L<torch lib> -ltorch -ltorch_cpu -ltorch_cuda -lc10 -lc10_cuda -ldl
//
// Usage:
//   aoti_runner --package yolox.aoti.pt2 --ops libtscd_torch_ops.so \
//       --height 640 --width 640 --classes 80 [--input img.f32]
//       [--dump-raw raw.f32] [--conf 0.25] [--nms 0.45] [--max-out 30]
//       [--iters 0]
//
// --input is a raw float32 NHWC (1,H,W,3) blob (0-255 pixels); without
// it a deterministic synthetic image is generated (the formula of
// pjrt_runner.cpp and of the Python golden). Detections print as:
//   det <x1> <y1> <x2> <y2> <score> <cls>
// --iters N > 0 also times N more runs of the package (input upload,
// forward, raw output read back) and prints `ms_per_image <ms>` to stderr.
// Convs and matmuls run in full fp32: cuDNN's and cuBLAS's TF32 off, as
// the port's fp32 checks run them.

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

extern "C" int32_t yolox_decode_nms(
    const float* raw, int64_t A, int64_t C, const int32_t* hw,
    const int32_t* strides, int64_t L, float conf_thresh,
    float nms_thresh, int32_t max_out, float* out);

namespace {

[[noreturn]] void die(const std::string& msg) {
  std::fprintf(stderr, "aoti_runner: %s\n", msg.c_str());
  std::exit(1);
}

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) die("cannot read " + path);
  std::stringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

}  // namespace

int main(int argc, char** argv) {
  std::string package_path, ops_path, input_path, dump_raw;
  int H = 128, W = 128, C = 5, max_out = 30, iters = 0;
  float conf = 0.25f, nms = 0.45f;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (++i >= argc) die("missing value for " + a);
      return argv[i];
    };
    if (a == "--package") package_path = next();
    else if (a == "--ops") ops_path = next();
    else if (a == "--input") input_path = next();
    else if (a == "--dump-raw") dump_raw = next();
    else if (a == "--height") H = std::atoi(next().c_str());
    else if (a == "--width") W = std::atoi(next().c_str());
    else if (a == "--classes") C = std::atoi(next().c_str());
    else if (a == "--conf") conf = std::atof(next().c_str());
    else if (a == "--nms") nms = std::atof(next().c_str());
    else if (a == "--max-out") max_out = std::atoi(next().c_str());
    else if (a == "--iters") iters = std::atoi(next().c_str());
    else if (a == "--help" || a == "-h") {
      std::printf("usage: aoti_runner --package <model.aoti.pt2> --ops <libtscd_torch_ops.so> "
                  "[--height H --width W --classes C --input img.f32 --dump-raw raw.f32 "
                  "--conf x --nms x --max-out n --iters n]\n");
      return 0;
    } else {
      die("unknown arg " + a);
    }
  }
  if (package_path.empty() || ops_path.empty())
    die("--package and --ops are required (see --help)");

  at::globalContext().setAllowTF32CuDNN(false);
  at::globalContext().setAllowTF32CuBLAS(false);

  // --- the hand kernels' ops, then the package ----------------------------
  if (dlopen(ops_path.c_str(), RTLD_NOW | RTLD_GLOBAL) == nullptr)
    die(std::string("cannot load the op library: ") + dlerror());
  torch::inductor::AOTIModelPackageLoader loader(package_path);
  std::fprintf(stderr, "loaded %s\n", package_path.c_str());

  // --- input -----------------------------------------------------------
  const size_t n_in = size_t(1) * H * W * 3;
  std::vector<float> img(n_in);
  if (!input_path.empty()) {
    std::string blob = read_file(input_path);
    if (blob.size() != n_in * sizeof(float))
      die("--input size mismatch: got " + std::to_string(blob.size()) +
          " bytes, want " + std::to_string(n_in * sizeof(float)));
    std::memcpy(img.data(), blob.data(), blob.size());
  } else {
    // deterministic synthetic image; keep in sync with the python golden
    // (tscd_torch/utils/native.py synth_image)
    for (size_t i = 0; i < n_in; ++i)
      img[i] = float((i * 2654435761u) % 256u);
  }

  // --- execute: upload, forward, read back ------------------------------
  auto run = [&]() {
    at::Tensor x = at::from_blob(img.data(), {1, H, W, 3}, at::kFloat).to(at::kCUDA);
    std::vector<at::Tensor> outs = loader.run({x});
    if (outs.size() != 1) die("the package returns " + std::to_string(outs.size()) +
                              " outputs, want 1 (export with --raw)");
    return outs[0].to(at::kCPU).contiguous();
  };
  at::Tensor out = run();
  if (out.dim() != 3 || out.scalar_type() != at::kFloat)
    die("unexpected output: want (1, A, 5+C) float32");
  const int64_t A = out.size(1), K = out.size(2);
  if (K != 5 + C)
    die("output K=" + std::to_string(K) + " but --classes says " + std::to_string(5 + C));
  std::fprintf(stderr, "output (1, %" PRId64 ", %" PRId64 ")\n", A, K);
  if (iters > 0) {
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < iters; ++i) run();
    const double ms = std::chrono::duration<double, std::milli>(
        std::chrono::steady_clock::now() - t0).count() / iters;
    std::fprintf(stderr, "ms_per_image %.4f\n", ms);
  }
  const float* raw = out.data_ptr<float>();

  if (!dump_raw.empty()) {
    std::ofstream f(dump_raw, std::ios::binary);
    f.write(reinterpret_cast<const char*>(raw), A * K * sizeof(float));
  }

  // --- decode + NMS (shared with the ctypes path) ----------------------
  std::vector<int32_t> hw, strides;
  for (int s : {8, 16, 32}) {
    hw.push_back(H / s);
    hw.push_back(W / s);
    strides.push_back(s);
  }
  int64_t expect_a = 0;
  for (size_t l = 0; l < strides.size(); ++l)
    expect_a += int64_t(hw[2 * l]) * hw[2 * l + 1];
  if (expect_a != A)
    die("anchor count mismatch: package says " + std::to_string(A) +
        ", grids say " + std::to_string(expect_a));

  std::vector<float> dets(size_t(max_out) * 7);
  int32_t n = yolox_decode_nms(raw, A, C, hw.data(), strides.data(),
                               (int64_t)strides.size(), conf, nms, max_out, dets.data());
  std::printf("detections %d\n", n);
  for (int32_t i = 0; i < n; ++i) {
    const float* d = &dets[size_t(i) * 7];
    std::printf("det %.2f %.2f %.2f %.2f %.4f %d\n", d[0], d[1], d[2],
                d[3], d[4] * d[5], (int)d[6]);
  }
  return 0;
}
