// The hand kernels an exported YOLOX meets, registered as torch ops in C++,
// for a process without Python: the AOTInductor runner
// (csrc/host/aoti_runner.cpp) loads this library, and the package's calls
// to tscd::* go through the dispatcher to these CUDA implementations.
//
// Each schema is the Python op's (tscd_torch/ops/kernels/ops.py, checked
// by tests/test_torch_port_export.py), and each implementation does what
// the Python launcher does: the same weight preparation (ATen ops in the
// same order, so the same roundings), then the kernel's C entry point (the
// library tscd_torch/ops/kernels/library.py builds from csrc/*.cu) on the
// current stream. Only CUDA is registered: a CPU tensor raises here.
//
// Built at first use by tscd_torch/ops/kernels/library.py:torch_ops_library
// (g++ against torch's headers and libraries, torch's C++ ABI).

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/Stream.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <string>

extern "C" {
int tscd_focus_stem(const void* x, const void* w, const void* shift, void* out, int F, int H,
                    int W, int C, int OC, void* stream);
int tscd_focus_stem_bf16(const void* x, const void* wfrag, void* out, int F, int H, int W,
                         int C, int OC, int x_u8, void* stream);
int tscd_int8_absmax(const void* x, long long n, int dtype, void* out, void* stream);
int tscd_int8_quantize(const void* x, int dtype, int F, int C, int H, int W, int Cp,
                       const void* scale, int mode, void* out, void* stream);
int tscd_int8_conv(const void* x, const void* w, const void* sx, const void* sw,
                   const void* bias, void* out, int F, int H, int W, int Cp, int N, int k,
                   int stride, int pad, int sx_mode, int act, int out_dtype, void* stream);
const char* tscd_error_string(int code);
}

namespace {

constexpr int64_t kTaps = 108;    // focus_stem.py TAPS
constexpr int64_t kMmaK = 112;    // MMA_K
constexpr int64_t kChunk = 32;    // CHUNK
constexpr int64_t kCAlign = 32;   // int8_conv.py C_ALIGN

void check(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, " launch failed: ", tscd_error_string(rc));
}

// the current stream of t's card (its cudaStream_t), through c10's device
// interface: no CUDA header needed
void* stream_of(const at::Tensor& t) {
  return c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)->getStream(t.device())
      .native_handle();
}

int dtype_code(const at::Tensor& t, const char* what) {
  TORCH_CHECK(t.scalar_type() == at::kFloat || t.scalar_type() == at::kBFloat16, what,
              " takes fp32 or bf16");
  return t.scalar_type() == at::kBFloat16 ? 1 : 0;
}

// focus_stem.py:rearrange_weight, times the folded BN scale
at::Tensor rearrange_weight(const at::Tensor& w3, const at::Tensor& scale) {
  const int64_t O = w3.size(0), C = w3.size(1) / 4, k = w3.size(2);
  at::Tensor w6 = w3.reshape({O, 2, 2, C, k, k}).permute({0, 3, 4, 2, 5, 1});
  w6 = w6.reshape({O, C, 2 * k, 2 * k});
  return w6 * scale.reshape({O, 1, 1, 1});
}

// focus_stem.py:shift_parts
at::Tensor shift_parts(const at::Tensor& shift) {
  const at::Tensor s = shift.to(at::kFloat);
  const at::Tensor hi = at::bitwise_and(s.view(at::kInt), -65536).view(at::kFloat);
  const at::Tensor rest = s - hi;
  const at::Tensor mid = at::bitwise_and(rest.view(at::kInt), -65536).view(at::kFloat);
  return at::stack({hi, mid, rest - mid}, -1);
}

// focus_stem.py:weight_fragments
at::Tensor weight_fragments(const at::Tensor& w3, const at::Tensor& scale,
                            const at::Tensor& shift) {
  const int64_t O = w3.size(0);
  const at::Tensor w6 = rearrange_weight(w3.to(at::kFloat), scale.to(at::kFloat));
  at::Tensor wm = at::cat({w6.permute({0, 2, 3, 1}).reshape({O, kTaps}), shift_parts(shift)}, 1);
  wm = at::constant_pad_nd(wm, {0, kMmaK - kTaps - 3, 0, (kChunk - O % kChunk) % kChunk})
           .to(at::kBFloat16);
  wm = wm.reshape({-1, 2, 2, 8, kMmaK / 16, 2, 4, 2}).permute({0, 4, 1, 3, 6, 5, 2, 7});
  return wm.reshape({-1, kMmaK / 16, 2, 32, 4, 2}).contiguous();
}

void check_stem(const at::Tensor& x, const at::Tensor& w3) {
  TORCH_CHECK(x.is_cuda(), "focus_stem: a CUDA tensor");
  TORCH_CHECK(x.dim() == 4 && x.size(3) == 3 && w3.dim() == 4 && w3.size(1) == 12 &&
                  w3.size(2) == 3 && w3.size(3) == 3,
              "focus_stem takes (F, H, W, 3) and (O, 12, 3, 3)");
  TORCH_CHECK(x.size(1) % 2 == 0 && x.size(2) % 2 == 0 && w3.size(0) % 8 == 0,
              "focus_stem needs even H, W and O a multiple of 8");
}

at::Tensor focus_stem(const at::Tensor& x, const at::Tensor& w3, const at::Tensor& scale,
                      const at::Tensor& shift) {
  check_stem(x, w3);
  c10::DeviceGuard guard(x.device());
  const int64_t F = x.size(0), H = x.size(1), W = x.size(2), O = w3.size(0);
  const at::Tensor xin = x.to(at::kFloat).contiguous();
  const at::Tensor wk =
      rearrange_weight(w3.to(at::kFloat), scale.to(at::kFloat)).permute({2, 3, 1, 0}).contiguous();
  const at::Tensor sh = shift.to(at::kFloat).contiguous();
  at::Tensor out = at::empty({F, O, H / 2, W / 2}, x.options().dtype(at::kFloat));
  check(tscd_focus_stem(xin.data_ptr(), wk.data_ptr(), sh.data_ptr(), out.data_ptr(), F, H, W, 3,
                        O, stream_of(x)),
        "focus_stem");
  return out;
}

at::Tensor focus_stem_bf16(const at::Tensor& x, const at::Tensor& w3, const at::Tensor& scale,
                           const at::Tensor& shift) {
  check_stem(x, w3);
  c10::DeviceGuard guard(x.device());
  const int64_t F = x.size(0), H = x.size(1), W = x.size(2), O = w3.size(0);
  const bool u8 = x.scalar_type() == at::kByte;
  const at::Tensor xin = u8 ? x.contiguous() : x.to(at::kFloat).contiguous();
  const at::Tensor wf = weight_fragments(w3, scale, shift);
  at::Tensor out = at::empty({F, O, H / 2, W / 2}, x.options().dtype(at::kBFloat16));
  check(tscd_focus_stem_bf16(xin.data_ptr(), wf.data_ptr(), out.data_ptr(), F, H, W, 3, O,
                             u8 ? 1 : 0, stream_of(x)),
        "focus_stem_bf16");
  return out;
}

at::Tensor int8_absmax(const at::Tensor& x) {
  TORCH_CHECK(x.is_cuda() && x.is_contiguous() && x.numel() > 0,
              "int8_absmax: a non-empty contiguous CUDA tensor");
  c10::DeviceGuard guard(x.device());
  at::Tensor out = at::empty({1}, x.options().dtype(at::kFloat));
  check(tscd_int8_absmax(x.data_ptr(), x.numel(), dtype_code(x, "int8_absmax"), out.data_ptr(),
                         stream_of(x)),
        "int8 abs max");
  return out;
}

at::Tensor int8_quantize(const at::Tensor& x, const at::Tensor& scale, int64_t mode) {
  TORCH_CHECK(x.is_cuda() && x.is_contiguous() && x.dim() == 4 && scale.is_contiguous() &&
                  scale.scalar_type() == at::kFloat,
              "int8_quantize: contiguous CUDA (F, C, H, W) and an fp32 scale");
  c10::DeviceGuard guard(x.device());
  const int64_t F = x.size(0), C = x.size(1), H = x.size(2), W = x.size(3);
  const int64_t Cp = (C + kCAlign - 1) / kCAlign * kCAlign;
  at::Tensor out = at::empty({F, H, W, Cp}, x.options().dtype(at::kChar));
  check(tscd_int8_quantize(x.data_ptr(), dtype_code(x, "int8_quantize"), F, C, H, W, Cp,
                           scale.data_ptr(), static_cast<int>(mode), out.data_ptr(),
                           stream_of(x)),
        "int8 quantize");
  return out;
}

at::Tensor int8_conv(const at::Tensor& xq, const at::Tensor& wq, const at::Tensor& s_w,
                     const at::Tensor& bias, const at::Tensor& sx, int64_t stride, int64_t pad,
                     bool static_scale, int64_t act, int64_t out) {
  TORCH_CHECK(xq.is_cuda() && xq.dim() == 4 && wq.dim() == 4 && xq.scalar_type() == at::kChar &&
                  wq.scalar_type() == at::kChar && xq.size(3) == wq.size(3),
              "int8_conv: CUDA int8 xq (F, H, W, Cp) and wq (N, k, k, Cp)");
  for (const at::Tensor* t : {&xq, &wq, &s_w, &bias, &sx})
    TORCH_CHECK(t->is_contiguous(), "int8_conv takes contiguous tensors");
  c10::DeviceGuard guard(xq.device());
  const int64_t F = xq.size(0), H = xq.size(1), W = xq.size(2), Cp = xq.size(3);
  const int64_t N = wq.size(0), k = wq.size(1);
  const int64_t Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
  const at::ScalarType dt = out == 2 ? at::kInt : (out == 1 ? at::kBFloat16 : at::kFloat);
  at::Tensor y = at::empty({F, N, Ho, Wo}, xq.options().dtype(dt));
  check(tscd_int8_conv(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), s_w.data_ptr(),
                       bias.data_ptr(), y.data_ptr(), F, H, W, Cp, N, k, stride, pad,
                       static_scale ? 1 : 0, static_cast<int>(act), static_cast<int>(out),
                       stream_of(xq)),
        "int8_conv");
  return y;
}

}  // namespace

TORCH_LIBRARY(tscd, m) {
  m.def("focus_stem(Tensor x, Tensor w3, Tensor scale, Tensor shift) -> Tensor");
  m.def("focus_stem_bf16(Tensor x, Tensor w3, Tensor scale, Tensor shift) -> Tensor");
  m.def("int8_absmax(Tensor x) -> Tensor");
  m.def("int8_quantize(Tensor x, Tensor scale, SymInt mode) -> Tensor");
  m.def("int8_conv(Tensor xq, Tensor wq, Tensor s_w, Tensor bias, Tensor sx, SymInt stride, "
        "SymInt pad, bool static_scale, SymInt act, SymInt out) -> Tensor");
}

TORCH_LIBRARY_IMPL(tscd, CUDA, m) {
  m.impl("focus_stem", &focus_stem);
  m.impl("focus_stem_bf16", &focus_stem_bf16);
  m.impl("int8_absmax", &int8_absmax);
  m.impl("int8_quantize", &int8_quantize);
  m.impl("int8_conv", &int8_conv);
}
