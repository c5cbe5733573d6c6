// Host image operations of the port's data path, each equal bit for bit
// to the OpenCV call the JAX package makes (tscd_tpu/data/vid.py):
//
//   tscd_bgr2hsv / tscd_hsv2bgr   cv2.cvtColor(COLOR_BGR2HSV / COLOR_HSV2BGR),
//                                 uint8, H in 0..179
//   tscd_hsv_jitter               the two around JAX's int16 gain arithmetic
//                                 (tscd_tpu/data/transforms.py:augment_hsv)
//   tscd_resize_linear            cv2.resize(INTER_LINEAR), uint8 HWC
//   tscd_resize_linear_f32        the same on the image cast to float32
//                                 (IPP's path in OpenCV), float32 out
//   tscd_warp_affine              cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT),
//                                 uint8 HWC, 3 channels
//   tscd_jpeg_info / _decode      cv2.imread(path): baseline JPEG -> BGR uint8
//                                 (libjpeg-turbo's islow IDCT, fancy
//                                 upsampling and YCbCr -> RGB arithmetic)
//   tscd_jpeg_encode              cv2.imencode(".jpg", img) at its defaults
//
// Plain C entry points, loaded with ctypes (which releases the GIL for the
// call), built with g++ by tscd_torch/data/image.py. Each returns 0, or a
// nonzero code with a message in `err`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

inline uint8_t sat_u8(int i) { return static_cast<uint8_t>(i < 0 ? 0 : (i > 255 ? 255 : i)); }

// ---------------------------------------------------------------- HSV ----
// OpenCV's RGB2HSV_b (imgproc/src/color_hsv.simd.hpp): fixed-point division
// tables with hsv_shift = 12, each entry cvRound (half to even) of a double.
constexpr int kHsvShift = 12;

struct HsvTables {
  int sdiv[256];
  int hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; i++) {
      sdiv[i] = static_cast<int>(std::lrint((255 << kHsvShift) / (1. * i)));
      hdiv[i] = static_cast<int>(std::lrint((180 << kHsvShift) / (6. * i)));
    }
  }
};
const HsvTables kHsv;

inline void bgr2hsv_px(const uint8_t* s, uint8_t* d) {
  const int b = s[0], g = s[1], r = s[2];
  int v = b, vmin = b;
  v = v > g ? v : g;
  v = v > r ? v : r;
  vmin = vmin < g ? vmin : g;
  vmin = vmin < r ? vmin : r;
  const int diff = v - vmin;
  const int vr = v == r ? -1 : 0;
  const int vg = v == g ? -1 : 0;
  const int sat = (diff * kHsv.sdiv[v] + (1 << (kHsvShift - 1))) >> kHsvShift;
  int h = (vr & (g - b)) +
          (~vr & ((vg & (b - r + 2 * diff)) + ((~vg) & (r - g + 4 * diff))));
  h = (h * kHsv.hdiv[diff] + (1 << (kHsvShift - 1))) >> kHsvShift;
  h += h < 0 ? 180 : 0;
  d[0] = sat_u8(h);
  d[1] = static_cast<uint8_t>(sat);
  d[2] = static_cast<uint8_t>(v);
}

// OpenCV's HSV2RGB_b: float32 throughout, H x (6/180), S and V x (1/255),
// the sector from truncation, 1 - s h and 1 - s (1 - h) fused (the AVX2
// build contracts them), then each channel x 255. Its vector loop takes 32
// pixels at a time and truncates the result; the rest of a row goes through
// the scalar code, which rounds half to even. Both saturate.
constexpr int kHsvBlock = 32;

// HSV2RGB_native's sector table {{1,3,0}, {1,0,2}, {3,0,1}, {0,2,1},
// {0,1,3}, {2,1,0}} (b, g, r of each sector) as selects, over chunks of a
// row held as planes, so that the arithmetic vectorizes.
template <bool kRound>
void hsv2bgr_span(const uint8_t* s, uint8_t* d, int64_t n) {
  constexpr int kChunk = 64;
  float hf[kChunk], sf[kChunk], vf[kChunk], out[3][kChunk];
  for (int64_t i0 = 0; i0 < n; i0 += kChunk) {
    const int m = static_cast<int>(n - i0 < kChunk ? n - i0 : kChunk);
    for (int j = 0; j < m; j++) {
      hf[j] = s[3 * (i0 + j)];
      sf[j] = s[3 * (i0 + j) + 1];
      vf[j] = s[3 * (i0 + j) + 2];
    }
    for (int j = 0; j < m; j++) {
      float h = hf[j] * (6.0f / 180);
      const float sat = sf[j] * (1.0f / 255.0f);
      const float v = vf[j] * (1.0f / 255.0f);
      const int k = static_cast<int>(h) % 6;
      h = h - static_cast<float>(static_cast<int>(h));
      const float t1 = v * (1.0f - sat), t2 = v * std::fmaf(-sat, h, 1.0f);
      const float t3 = v * std::fmaf(-sat, 1.0f - h, 1.0f);
      out[0][j] = (k == 0 || k == 1) ? t1 : k == 2 ? t3 : (k == 3 || k == 4) ? v : t2;
      out[1][j] = k == 0 ? t3 : (k == 1 || k == 2) ? v : k == 3 ? t2 : t1;
      out[2][j] = (k == 0 || k == 5) ? v : k == 1 ? t2 : (k == 2 || k == 3) ? t1 : t3;
    }
    for (int c = 0; c < 3; c++)
      for (int j = 0; j < m; j++) {
        const float x = out[c][j] * 255.0f;
        out[c][j] = static_cast<float>(kRound ? std::lrintf(x) : static_cast<int>(x));
      }
    for (int j = 0; j < m; j++)
      for (int c = 0; c < 3; c++) d[3 * (i0 + j) + c] = sat_u8(static_cast<int>(out[c][j]));
  }
}

inline void hsv2bgr_row(const uint8_t* s, uint8_t* d, int64_t w) {
  const int64_t simd = w / kHsvBlock * kHsvBlock;
  hsv2bgr_span<false>(s, d, simd);
  hsv2bgr_span<true>(s + 3 * simd, d + 3 * simd, w - simd);
}

// ------------------------------------------------------------- resize ----
// OpenCV's cv::resize for uint8 with INTER_LINEAR (imgproc/src/resize.cpp):
// an exact 2x downscale in both axes is its INTER_AREA fast path; every
// other size is the fixed-point bilinear path, INTER_RESIZE_COEF_BITS = 11.
constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;

inline short sat_short_round(float x) {
  const int i = static_cast<int>(std::lrintf(x));
  return static_cast<short>(i < -32768 ? -32768 : (i > 32767 ? 32767 : i));
}

// The vertical pass as OpenCV's vector code (VResizeLinearVec_32s8u)
// computes it, for every value of the row, the last ones too: each row sum
// >> 4 packed to int16, the high half of its product with the int16 weight,
// the two added and rounded by (x + 2) >> 2 (not FixedPtCast's exact
// (s0 b0 + s1 b1 + 2^21) >> 22).
inline uint8_t vresize(int s0, int s1, int b0, int b1) {
  auto pack16 = [](int x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); };
  const int a = (pack16(s0 >> 4) * b0) >> 16;
  const int b = (pack16(s1 >> 4) * b1) >> 16;
  const int t = pack16(a + b);
  return sat_u8(pack16(t + 2) >> 2);
}

void resize_area2(const uint8_t* src, int64_t sstride, uint8_t* dst, int dh, int dw, int cn) {
  const int64_t drow = static_cast<int64_t>(dw) * cn;
  for (int y = 0; y < dh; y++) {
    const uint8_t* s0 = src + (2 * y) * sstride;
    const uint8_t* s1 = s0 + sstride;
    uint8_t* d = dst + y * drow;
    for (int64_t x = 0; x < drow; x++) {
      const int64_t i = x / cn * 2 * cn + x % cn;
      d[x] = static_cast<uint8_t>((s0[i] + s0[i + cn] + s1[i] + s1[i + cn] + 2) >> 2);
    }
  }
}

void resize_linear(const uint8_t* src, int sh, int sw, int64_t sstride, uint8_t* dst,
                   int dh, int dw, int cn) {
  const double scale_x = 1. / (static_cast<double>(dw) / sw);
  const double scale_y = 1. / (static_cast<double>(dh) / sh);
  if (scale_x == 2.0 && scale_y == 2.0) return resize_area2(src, sstride, dst, dh, dw, cn);
  const int64_t drow = static_cast<int64_t>(dw) * cn;
  // per output value: its two source values and their weights x 2^11 (at
  // the right border the second weight is 0 and the second source is the
  // first)
  std::vector<int> ofs0(drow), ofs1(drow), a0(drow), a1(drow);
  for (int dx = 0; dx < dw; dx++) {
    float fx = static_cast<float>((dx + 0.5) * scale_x - 0.5);
    int sx = static_cast<int>(std::floor(fx));
    fx -= sx;
    if (sx < 0) fx = 0, sx = 0;
    if (sx >= sw - 1) fx = 0, sx = sw - 1;
    const int w0 = sat_short_round((1.f - fx) * kCoefScale);
    const int w1 = sat_short_round(fx * kCoefScale);
    for (int c = 0; c < cn; c++) {
      const int i = dx * cn + c;
      ofs0[i] = sx * cn + c;
      ofs1[i] = sx + 1 < sw ? ofs0[i] + cn : ofs0[i];
      a0[i] = w0;
      a1[i] = w1;
    }
  }
  // the horizontal pass of a source row, exact in int
  auto hresize = [&](int sy, int* out) {
    const uint8_t* s = src + sy * sstride;
    for (int64_t i = 0; i < drow; i++) out[i] = s[ofs0[i]] * a0[i] + s[ofs1[i]] * a1[i];
  };
  std::vector<int> buf(2 * drow);
  int* slot[2] = {buf.data(), buf.data() + drow};
  int tag[2] = {-1, -1};
  auto row = [&](int y, const int* keep) -> const int* {
    for (int k = 0; k < 2; k++)
      if (tag[k] == y) return slot[k];
    const int k = slot[0] == keep ? 1 : 0;
    hresize(y, slot[k]);
    tag[k] = y;
    return slot[k];
  };
  for (int dy = 0; dy < dh; dy++) {
    float fy = static_cast<float>((dy + 0.5) * scale_y - 0.5);
    const int sy = static_cast<int>(std::floor(fy));
    fy -= sy;
    const int b0 = sat_short_round((1.f - fy) * kCoefScale);
    const int b1 = sat_short_round(fy * kCoefScale);
    const int y0 = sy < 0 ? 0 : (sy >= sh ? sh - 1 : sy);
    const int y1 = sy + 1 < 0 ? 0 : (sy + 1 >= sh ? sh - 1 : sy + 1);
    const int* r0 = row(y0, nullptr);
    const int* r1 = row(y1, r0);
    uint8_t* d = dst + dy * drow;
    for (int64_t x = 0; x < drow; x++) d[x] = vresize(r0[x], r1[x], b0, b1);
  }
}

// cv::resize for float32 with INTER_LINEAR, which OpenCV hands to IPP
// (ippiResizeLinear_32f; its own path, the one above, only without IPP):
// per axis the source coordinate (d + 0.5) * src / dst - 0.5 in double,
// its fraction t rounded to float, the two neighbours clamped to the image;
// a row is first resized across, fma(b - a, t, a), then the two rows down,
// in the same form. The uint8 source values are exact in float32. Held to
// cv2 for sources of 2 px and more a side and up to 8x wider; beyond
// that IPP treats the borders otherwise, and the call refuses.
void resize_axis(int dn, int sn, std::vector<int>& i0, std::vector<int>& i1,
                 std::vector<float>& t) {
  const double scale = static_cast<double>(sn) / dn;
  i0.resize(dn);
  i1.resize(dn);
  t.resize(dn);
  for (int d = 0; d < dn; d++) {
    const double f = (d + 0.5) * scale - 0.5;
    const double s = std::floor(f);
    t[d] = static_cast<float>(f - s);
    const int k = static_cast<int>(s);
    i0[d] = std::min(std::max(k, 0), sn - 1);
    i1[d] = std::min(std::max(k + 1, 0), sn - 1);
  }
}

void resize_linear_f32(const uint8_t* src, int sh, int sw, int64_t sstride, float* dst,
                       int dh, int dw, int cn) {
  std::vector<int> x0, x1, y0, y1;
  std::vector<float> tx, ty;
  resize_axis(dw, sw, x0, x1, tx);
  resize_axis(dh, sh, y0, y1, ty);
  const int64_t drow = static_cast<int64_t>(dw) * cn;
  // per output value: its two source values' offsets and the fraction
  std::vector<int> ofs0(drow), ofs1(drow);
  std::vector<float> t(drow);
  for (int dx = 0; dx < dw; dx++)
    for (int c = 0; c < cn; c++) {
      ofs0[dx * cn + c] = x0[dx] * cn + c;
      ofs1[dx * cn + c] = x1[dx] * cn + c;
      t[dx * cn + c] = tx[dx];
    }
  std::vector<float> line(static_cast<size_t>(sw) * cn);
  auto hresize = [&](int sy, float* out) {
    const uint8_t* s = src + sy * sstride;
    for (size_t i = 0; i < line.size(); i++) line[i] = s[i];
    const float* l = line.data();
    for (int64_t i = 0; i < drow; i++) {
      const float a = l[ofs0[i]];
      out[i] = std::fmaf(l[ofs1[i]] - a, t[i], a);
    }
  };
  std::vector<float> buf(2 * drow);
  float* slot[2] = {buf.data(), buf.data() + drow};
  int tag[2] = {-1, -1};
  auto row = [&](int y, const float* keep) -> const float* {
    for (int k = 0; k < 2; k++)
      if (tag[k] == y) return slot[k];
    const int k = slot[0] == keep ? 1 : 0;
    hresize(y, slot[k]);
    tag[k] = y;
    return slot[k];
  };
  for (int dy = 0; dy < dh; dy++) {
    const float* r0 = row(y0[dy], nullptr);
    const float* r1 = row(y1[dy], r0);
    float* d = dst + dy * drow;
    const float t = ty[dy];
    for (int64_t x = 0; x < drow; x++) d[x] = std::fmaf(r1[x] - r0[x], t, r0[x]);
  }
}

// --------------------------------------------------------------- JPEG ----
// A baseline JPEG decoder that gives what cv2.imread gives: OpenCV reads
// through libjpeg-turbo with its defaults (islow IDCT, fancy upsampling) and
// asks for JCS_EXT_BGR. Every step below is libjpeg-turbo's C reference
// arithmetic: jdhuff.c (decode_mcu, with its behaviour at a marker),
// jidctint.c (jpeg_idct_islow, in 32 bits as its SIMD versions), jdsample.c
// (h2v1 / h2v2 fancy upsampling, with the context rows of jdmainct.c),
// jdcolor.c (ycc_rgb_convert, gray_rgb_convert). Only the loops are
// arranged for speed: the 8 columns, then the 8 rows, of a block's IDCT as
// vectors, the colour tables' entries computed in place.

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// zigzag position -> natural (row-major) index; 16 spare entries absorb a
// run past the block's end, as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (code length << 8) | symbol; 0: longer code
  // an AC code and its magnitude bits within the lookahead: (value << 16) |
  // (run << 4) | bits taken; 0: take the general path
  int32_t fast_ac[1 << kLookBits];

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; len++) {
      valoffset[len] = k - code;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
          if (len <= kLookBits) {
            const int shift = kLookBits - len;
            for (int j = 0; j < (1 << shift); j++)
              look[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      if (code > (1 << len)) fail("a Huffman table has more codes than its lengths allow");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < (1 << kLookBits); i++) {
      fast_ac[i] = 0;
      const int len = look[i] >> 8, rs = look[i] & 0xFF, size = rs & 15;
      if (!look[i] || !size || len + size > kLookBits) continue;
      const int v = (i >> (kLookBits - len - size)) & ((1 << size) - 1);
      const int val = v < (1 << (size - 1)) ? v + 1 - (1 << size) : v;
      fast_ac[i] = static_cast<int32_t>(static_cast<uint32_t>(val) << 16) | ((rs >> 4) << 4) |
                   (len + size);
    }
    defined = true;
  }
};

// Entropy-coded bits: 0xFF00 is a 0xFF byte; at a marker (or the end of the
// data) zeros follow, as in libjpeg, and a read into them marks the data
// as insufficient: a truncated or corrupt scan, where cv2 fills in what
// libjpeg makes of it and the decoder raises.
struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  int fake = 0;       // zero bits past a marker, at the bottom of acc
  bool at_marker = false;
  bool insufficient = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!at_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          const int next = pos + 1 < len ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          pos++;
        }
      } else {
        at_marker = true;
      }
      if (at_marker) fake += 8;
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < fake) {
      insufficient = true;
      fake = nbits;
    }
  }
  inline int bits(int n) {
    if (n == 0) return 0;
    const int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  int decode(const Huffman& h) {
    const uint32_t top = peek(16);
    const int e = h.look[top >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int len = kLookBits + 1;
    int code = static_cast<int>(top >> (16 - len));
    while (len <= 16 && code > h.maxcode[len]) {
      len++;
      code = static_cast<int>(top >> (16 - len));
    }
    if (len > 16) {  // libjpeg: warn, return symbol 0
      skip(16);
      return 0;
    }
    skip(len);
    return h.vals[code + h.valoffset[len]];
  }
  void reset_at(size_t p) {
    pos = p;
    acc = 0;
    nbits = fake = 0;
    at_marker = false;
  }
};

inline int extend(int v, int n) { return v < (1 << (n - 1)) ? v + 1 - (1 << n) : v; }

// jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr uint32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                   F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                   F2562 = 20995, F3072 = 25172;

// One 1-D pass of jpeg_idct_islow on 8 vectors at once: in[k][lane] is
// input k of lane `lane`, out[k][lane] output k, descaled by `shift`. The
// lanes are the block's columns in pass 1 and its rows in pass 2, so each
// statement is one vector operation. The arithmetic is jidctint.c's in 32
// bits, as libjpeg-turbo's SIMD IDCT does it: a valid JPEG's dequantized
// coefficients are within +-2^11, far from overflow; a corrupt one wraps
// (unsigned arithmetic, then an arithmetic shift).
inline void idct_pass(const int32_t (*in)[8], int32_t (*out)[8], int shift) {
  using u32 = uint32_t;
  const u32 round = u32{1} << (shift - 1);
  for (int l = 0; l < 8; l++) {
    const u32 z2 = in[2][l], z3 = in[6][l];
    const u32 z1 = (z2 + z3) * F0541;
    const u32 e2 = z1 - z3 * F1847, e3 = z1 + z2 * F0765;
    const u32 e0 = (u32(in[0][l]) + u32(in[4][l])) << kConstBits;
    const u32 e1 = (u32(in[0][l]) - u32(in[4][l])) << kConstBits;
    const u32 t10 = e0 + e3, t13 = e0 - e3, t11 = e1 + e2, t12 = e1 - e2;
    u32 o0 = in[7][l], o1 = in[5][l], o2 = in[3][l], o3 = in[1][l];
    const u32 y1 = o0 + o3, y2 = o1 + o2, y3 = o0 + o2, y4 = o1 + o3;
    const u32 z5 = (y3 + y4) * F1175;
    const u32 w1 = 0u - y1 * F0899, w2 = 0u - y2 * F2562;
    const u32 w3 = z5 - y3 * F1961, w4 = z5 - y4 * F0390;
    o0 = o0 * F0298 + w1 + w3;
    o1 = o1 * F2053 + w2 + w4;
    o2 = o2 * F3072 + w2 + w3;
    o3 = o3 * F1501 + w1 + w4;
    auto d = [&](u32 x) { return static_cast<int32_t>(x + round) >> shift; };
    out[0][l] = d(t10 + o3);
    out[7][l] = d(t10 - o3);
    out[1][l] = d(t11 + o2);
    out[6][l] = d(t11 - o2);
    out[2][l] = d(t12 + o1);
    out[5][l] = d(t12 - o1);
    out[3][l] = d(t13 + o0);
    out[4][l] = d(t13 - o0);
  }
}

// libjpeg's IDCT output range limit: x & 1023 read as a signed 10-bit
// number, plus 128, clamped (prepare_range_limit_table's second half)
inline uint8_t idct_limit(int32_t x) {
  const int32_t v = ((x + 512) & 1023) - 512 + 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jpeg_idct_islow on one block of dequantized coefficients (natural
// order). Its all-zero shortcuts (a column's or a row's AC terms) give what
// the full arithmetic gives, so it goes without them.
void idct_islow(const int32_t* coef, uint8_t* out, int stride) {
  int32_t ws[8][8], rows[8][8], res[8][8];
  idct_pass(reinterpret_cast<const int32_t (*)[8]>(coef), ws, kConstBits - kPass1Bits);
  for (int r = 0; r < 8; r++)        // ws[k][c] -> rows[k][r]: row r's input k
    for (int k = 0; k < 8; k++) rows[k][r] = ws[r][k];
  idct_pass(rows, res, kConstBits + kPass1Bits + 3);
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) out[r * stride + c] = idct_limit(res[c][r]);
}

// jdcolor.c's YCbCr -> RGB (SCALEBITS 16): its tables' entries, computed
// in place (the same integer for each index, so the loop vectorizes)
constexpr int kColorBits = 16;
constexpr int32_t kColorHalf = 1 << (kColorBits - 1);
constexpr int32_t fix16(double x) { return static_cast<int32_t>(x * (1 << kColorBits) + 0.5); }
constexpr int32_t kCrR = fix16(1.40200), kCbB = fix16(1.77200), kCrG = fix16(0.71414),
                  kCbG = fix16(0.34414);

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int width = 0, height = 0;    // downsampled_width / _height
  int bw = 0, bh = 0;           // blocks a row / column in the plane
  int stride = 0;
  uint8_t* plane = nullptr;     // the decoding thread's buffer (`planes`)
  int pred = 0;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  int restart = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  size_t scan_pos = 0;   // first byte of the entropy-coded data
  int scan_comp[3] = {0, 1, 2};
  int scan_ncomp = 0;
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

void parse_exif(Jpeg& j, const uint8_t* p, int n) {
  if (n < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
  const uint8_t* t = p + 6;
  const int tn = n - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return;
  auto u16 = [&](int o) { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
  auto u32 = [&](int o) {
    return le ? static_cast<uint32_t>(t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | (t[o + 3] << 24))
              : static_cast<uint32_t>((t[o] << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3]);
  };
  const uint32_t ifd = u32(4);
  if (ifd + 2 > static_cast<uint32_t>(tn)) return;
  const int count = u16(static_cast<int>(ifd));
  for (int i = 0; i < count; i++) {
    const int e = static_cast<int>(ifd) + 2 + 12 * i;
    if (e + 12 > tn) return;
    if (u16(e) == 0x0112) {
      j.orientation = u16(e + 8);
      return;
    }
  }
}

// Reads the markers up to the first SOS; raises on what cv2 would decode
// otherwise than a baseline sequential decoder does.
void parse_header(Jpeg& j, const uint8_t* d, size_t n) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  size_t pos = 2;
  bool sof = false;
  for (;;) {
    while (pos < n && d[pos] != 0xFF) pos++;   // libjpeg skips stray bytes
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) fail("the JPEG data ends before its first scan");
    const int m = d[pos++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) fail("the JPEG data ends before its first scan");
    if (pos + 2 > n) fail("truncated JPEG marker");
    const int len = be16(d + pos);
    if (len < 2 || pos + len > n) fail("truncated JPEG marker segment");
    const uint8_t* p = d + pos + 2;
    const int pl = len - 2;
    pos += len;
    switch (m) {
      case 0xC0:
      case 0xC1: {
        if (sof) fail("two SOF markers");
        sof = true;
        if (pl < 6) fail("bad SOF segment");
        if (p[0] != 8) fail("a " + std::to_string(p[0]) + "-bit JPEG: only 8-bit samples are read");
        j.height = be16(p + 1);
        j.width = be16(p + 3);
        j.ncomp = p[5];
        if (j.height == 0) fail("a JPEG whose height comes in a DNL marker is not read");
        if (j.width == 0) fail("a JPEG of width 0");
        if (j.ncomp != 1 && j.ncomp != 3)
          fail(std::to_string(j.ncomp) + "-component JPEG (CMYK/YCCK or other): only "
               "grayscale and YCbCr are read");
        if (pl < 6 + 3 * j.ncomp) fail("bad SOF segment");
        for (int c = 0; c < j.ncomp; c++) {
          Component& k = j.comp[c];
          k.id = p[6 + 3 * c];
          k.h = p[7 + 3 * c] >> 4;
          k.v = p[7 + 3 * c] & 15;
          k.tq = p[8 + 3 * c];
          if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) fail("bad SOF component");
        }
        break;
      }
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        fail("a progressive JPEG: only baseline (sequential Huffman) JPEGs are read");
      case 0xC3:
      case 0xC5:
      case 0xC7:
      case 0xCB:
      case 0xCD:
      case 0xCF:
        fail("a lossless or hierarchical JPEG: only baseline JPEGs are read");
      case 0xC9:
      case 0xCC:
        fail("an arithmetic-coded JPEG: only Huffman-coded JPEGs are read");
      case 0xC4: {
        int q = 0;
        while (q < pl) {
          if (q + 17 > pl) fail("bad DHT segment");
          const int tc = p[q] >> 4, th = p[q] & 15;
          if (tc > 1 || th > 3) fail("bad DHT table id");
          int total = 0;
          for (int i = 0; i < 16; i++) total += p[q + 1 + i];
          if (total > 256 || q + 17 + total > pl) fail("bad DHT segment");
          (tc ? j.ac[th] : j.dc[th]).build(p + q + 1, p + q + 17, total);
          q += 17 + total;
        }
        break;
      }
      case 0xDB: {
        int q = 0;
        while (q < pl) {
          const int pq = p[q] >> 4, tq = p[q] & 15;
          if (tq > 3 || pq > 1) fail("bad DQT segment");
          if (q + 1 + 64 * (pq + 1) > pl) fail("bad DQT segment");
          for (int i = 0; i < 64; i++)
            j.qt[tq][kNatural[i]] = static_cast<uint16_t>(
                pq ? be16(p + q + 1 + 2 * i) : p[q + 1 + i]);
          j.qt_defined[tq] = true;
          q += 1 + 64 * (pq + 1);
        }
        break;
      }
      case 0xDD:
        if (pl < 2) fail("bad DRI segment");
        j.restart = be16(p);
        break;
      case 0xE0:
        if (pl >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) j.jfif = true;
        break;
      case 0xE1:
        parse_exif(j, p, pl);
        break;
      case 0xEE:
        if (pl >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          j.adobe = true;
          j.adobe_transform = p[11];
        }
        break;
      case 0xDA: {
        if (!sof) fail("a scan before the frame header");
        if (pl < 1) fail("bad SOS segment");
        j.scan_ncomp = p[0];
        if (pl < 4 + 2 * j.scan_ncomp) fail("bad SOS segment");
        if (j.scan_ncomp != j.ncomp)
          fail("a JPEG with one scan a component: only single-scan baseline JPEGs are read");
        for (int i = 0; i < j.scan_ncomp; i++) {
          const int cs = p[1 + 2 * i];
          int c = 0;
          while (c < j.ncomp && j.comp[c].id != cs) c++;
          if (c == j.ncomp) fail("a scan names a component the frame lacks");
          j.scan_comp[i] = c;
          j.comp[c].td = p[2 + 2 * i] >> 4;
          j.comp[c].ta = p[2 + 2 * i] & 15;
          if (j.comp[c].td > 3 || j.comp[c].ta > 3) fail("bad SOS table id");
        }
        const int ss = p[1 + 2 * j.scan_ncomp], se = p[2 + 2 * j.scan_ncomp];
        const int ahal = p[3 + 2 * j.scan_ncomp];
        if (ss != 0 || se != 63 || ahal != 0) fail("a scan that is not baseline sequential");
        j.scan_pos = pos;
        return;
      }
      default:
        break;   // APPn, COM and others: skipped
    }
  }
}

void check_supported(const Jpeg& j) {
  if (j.orientation >= 2 && j.orientation <= 8)
    fail("EXIF orientation " + std::to_string(j.orientation) +
         ": cv2.imread would rotate the image, which is not done here");
  if (j.ncomp == 3) {
    if (!j.jfif && j.adobe && j.adobe_transform == 0)
      fail("an RGB JPEG (Adobe transform 0): only YCbCr JPEGs are read");
    if (!j.jfif && !j.adobe && j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B')
      fail("an RGB JPEG (component ids R, G, B): only YCbCr JPEGs are read");
    const Component &y = j.comp[0], &cb = j.comp[1], &cr = j.comp[2];
    const bool luma_ok = (y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) || (y.h == 2 && y.v == 2);
    if (!luma_ok || cb.h != 1 || cb.v != 1 || cr.h != 1 || cr.v != 1)
      fail("JPEG sampling factors other than 4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2)");
  }
  for (int c = 0; c < j.ncomp; c++) {
    const Component& k = j.comp[c];
    if (!j.qt_defined[k.tq]) fail("a component's quantization table is not defined");
    if (!j.dc[k.td].defined || !j.ac[k.ta].defined)
      fail("a component's Huffman table is not defined");
  }
}

// Decodes the scan's MCUs into the component planes (samples after IDCT).
void decode_scan(Jpeg& j, const uint8_t* d, size_t n) {
  int hmax = 1, vmax = 1;
  for (int c = 0; c < j.ncomp; c++) {
    hmax = std::max(hmax, j.comp[c].h);
    vmax = std::max(vmax, j.comp[c].v);
  }
  j.hmax = hmax;
  j.vmax = vmax;
  const bool single = j.ncomp == 1;
  const int mcux = single ? (j.width + 7) / 8 : (j.width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = single ? (j.height + 7) / 8 : (j.height + 8 * vmax - 1) / (8 * vmax);
  for (int c = 0; c < j.ncomp; c++) {
    Component& k = j.comp[c];
    k.width = (j.width * k.h + hmax - 1) / hmax;
    k.height = (j.height * k.v + vmax - 1) / vmax;
    k.bw = single ? mcux : mcux * k.h;
    k.bh = single ? mcuy : mcuy * k.v;
    k.stride = 8 * k.bw;
    // every block of the plane is written below; the buffers stay with the
    // thread, so a frame of the same size allocates and faults in nothing
    thread_local std::vector<uint8_t> planes[3];
    planes[c].resize(static_cast<size_t>(k.stride) * 8 * k.bh);
    k.plane = planes[c].data();
    k.pred = 0;
  }
  BitReader br{d, n, j.scan_pos};
  int32_t coef[64];
  int32_t deq[64];
  const int total = mcux * mcuy;
  int restarts_to_go = j.restart;
  int next_rst = 0;
  for (int m = 0; m < total; m++) {
    if (j.restart) {
      if (restarts_to_go == 0) {
        // process_restart: the marker at the position the bits reached
        size_t p = br.pos;
        while (p < n && d[p] != 0xFF) p++;   // discarded bytes
        while (p + 1 < n && d[p + 1] == 0xFF) p++;
        const int marker = p + 1 < n ? d[p + 1] : 0xD9;
        if (marker != 0xD0 + next_rst)
          fail("a missing or out-of-order JPEG restart marker (truncated or corrupt data)");
        br.reset_at(p + 2);
        for (int c = 0; c < j.ncomp; c++) j.comp[c].pred = 0;
        next_rst = (next_rst + 1) & 7;
        restarts_to_go = j.restart;
      }
      restarts_to_go--;
    }
    const int mx = m % mcux, my = m / mcux;
    for (int ci = 0; ci < j.scan_ncomp; ci++) {
      Component& k = j.comp[j.scan_comp[ci]];
      const int bx_n = single ? 1 : k.h, by_n = single ? 1 : k.v;
      const uint16_t* q = j.qt[k.tq];
      for (int by = 0; by < by_n; by++)
        for (int bx = 0; bx < bx_n; bx++) {
          std::memset(coef, 0, sizeof(coef));
          bool has_ac = false;
          int s = br.decode(j.dc[k.td]);
          if (s) s = extend(br.bits(s), s);
          k.pred += s;
          coef[0] = static_cast<int16_t>(k.pred);
          const Huffman& ac = j.ac[k.ta];
          for (int z = 1; z < 64; z++) {
            const int32_t f = ac.fast_ac[br.peek(kLookBits)];
            if (f) {
              br.skip(f & 15);
              z += (f >> 4) & 15;
              coef[kNatural[z]] = static_cast<int16_t>(f >> 16);
              has_ac = true;
              continue;
            }
            const int rs = br.decode(ac);
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
              z += r;
              coef[kNatural[z]] = static_cast<int16_t>(extend(br.bits(s), s));
              has_ac = true;
            } else {
              if (r != 15) break;
              z += 15;
            }
          }
          const int row = (single ? my : my * k.v + by) * 8;
          const int col = (single ? mx : mx * k.h + bx) * 8;
          uint8_t* out = k.plane + static_cast<size_t>(row) * k.stride + col;
          if (!has_ac) {
            // only the DC term: both passes of jpeg_idct_islow take their
            // all-zero shortcut, so every sample is the same
            const uint32_t dc = (static_cast<uint32_t>(coef[0]) * q[0]) << kPass1Bits;
            const uint8_t v = idct_limit(
                static_cast<int32_t>(dc + (1u << (kPass1Bits + 2))) >> (kPass1Bits + 3));
            for (int r = 0; r < 8; r++) std::memset(out + r * k.stride, v, 8);
            continue;
          }
          for (int i = 0; i < 64; i++)
            deq[i] = static_cast<int32_t>(static_cast<uint32_t>(coef[i]) * q[i]);
          idct_islow(deq, out, k.stride);
        }
    }
    if (br.insufficient)
      fail("the JPEG data ends inside its scan (a truncated or corrupt file; cv2 "
           "would fill the rest in)");
  }
}

// One output row of an upsampled chroma plane (jdsample.c), `out` holding
// 2 * k.width samples for h2, k.width for h1.
void upsample_row(const Jpeg& j, const Component& k, int y, uint8_t* out) {
  const int h2 = j.hmax / k.h == 2, v2 = j.vmax / k.v == 2;
  const int w = k.width;
  const bool fancy = w > 2 || (!h2 && v2);
  const int iy = v2 ? y >> 1 : y;
  const uint8_t* in0 = k.plane + static_cast<size_t>(iy) * k.stride;
  if (!h2) {   // h1v1: the plane's row as it is
    std::memcpy(out, in0, w);
    return;
  }
  if (!fancy) {   // h2v1_upsample / h2v2_upsample: replication
    for (int x = 0; x < w; x++) out[2 * x] = out[2 * x + 1] = in0[x];
    return;
  }
  if (!v2) {   // h2v1_fancy_upsample
    int inv = in0[0];
    out[0] = static_cast<uint8_t>(inv);
    out[1] = static_cast<uint8_t>((inv * 3 + in0[1] + 2) >> 2);
    for (int x = 1; x < w - 1; x++) {
      inv = in0[x] * 3;
      out[2 * x] = static_cast<uint8_t>((inv + in0[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((inv + in0[x + 1] + 2) >> 2);
    }
    inv = in0[w - 1];
    out[2 * w - 2] = static_cast<uint8_t>((inv * 3 + in0[w - 2] + 1) >> 2);
    out[2 * w - 1] = static_cast<uint8_t>(inv);
    return;
  }
  // h2v2_fancy_upsample: the nearer row x 3 + the farther one (the row above
  // for even output rows, below for odd; the first and last real rows
  // stand in past the plane's edges), then 3:1 across columns
  int iy1 = (y & 1) ? iy + 1 : iy - 1;
  iy1 = iy1 < 0 ? 0 : (iy1 >= k.height ? k.height - 1 : iy1);
  const uint8_t* in1 = k.plane + static_cast<size_t>(iy1) * k.stride;
  int this_sum = in0[0] * 3 + in1[0];
  int next_sum = in0[1] * 3 + in1[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < w - 1; x++) {
    next_sum = in0[x + 1] * 3 + in1[x + 1];
    out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * w - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * w - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

void to_bgr(const Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  if (j.ncomp == 1) {
    const Component& k = j.comp[0];
    for (int y = 0; y < H; y++) {
      const uint8_t* s = k.plane + static_cast<size_t>(y) * k.stride;
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
    }
    return;
  }
  const Component &ky = j.comp[0], &kb = j.comp[1], &kr = j.comp[2];
  std::vector<uint8_t> cb(2 * kb.width + 16), cr(2 * kr.width + 16);
  for (int y = 0; y < H; y++) {
    upsample_row(j, kb, y, cb.data());
    upsample_row(j, kr, y, cr.data());
    const uint8_t* yy = ky.plane + static_cast<size_t>(y) * ky.stride;
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; x++) {
      const int32_t Y = yy[x], B = cb[x] - 128, R = cr[x] - 128;
      const int32_t r = Y + ((kCrR * R + kColorHalf) >> kColorBits);
      const int32_t g = Y + ((-kCbG * B + kColorHalf - kCrG * R) >> kColorBits);
      const int32_t b = Y + ((kCbB * B + kColorHalf) >> kColorBits);
      o[3 * x] = static_cast<uint8_t>(b < 0 ? 0 : (b > 255 ? 255 : b));
      o[3 * x + 1] = static_cast<uint8_t>(g < 0 ? 0 : (g > 255 ? 255 : g));
      o[3 * x + 2] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
    }
  }
}

// ---------------------------------------------------------- warpAffine ----
// cv2 5.0.0's warpAffine, INTER_LINEAR, BORDER_CONSTANT, uint8 with 3
// channels (imgproc/src/warp_kernels.simd.hpp, the AVX2 build): the matrix
// inverted in double as warpAffine inverts it, then rounded to float. Each
// output pixel reads the source at (sx, sy) in float: in blocks of 16
// pixels a row (the vector loop) sx = fma(M0, x, row_x) with row_x =
// y * M1 + M2 rounded once; the last width % 16 pixels (the scalar tail,
// whose x * M0 + y * M1 + M2 the compiler contracted) sx = fma(x, M0,
// y * M1) + M2. The 4 neighbours (the border value outside the source) are
// blended in float, across with fma(alpha, p01 - p00, p00), then down, and
// rounded half to even.
void warp_affine_linear(const uint8_t* src, int sh, int sw, int64_t sstride, uint8_t* dst,
                        int dh, int dw, const double* Mf, int border) {
  double D = Mf[0] * Mf[4] - Mf[1] * Mf[3];
  D = D != 0 ? 1. / D : 0;
  const double a11 = Mf[4] * D, a22 = Mf[0] * D, a12 = Mf[1] * -D, a21 = Mf[3] * -D;
  const double b1 = -a11 * Mf[2] - a12 * Mf[5];
  const double b2 = -a21 * Mf[2] - a22 * Mf[5];
  const float m[6] = {static_cast<float>(a11), static_cast<float>(a12), static_cast<float>(b1),
                      static_cast<float>(a21), static_cast<float>(a22), static_cast<float>(b2)};
  const int vec_end = dw - dw % 16;
  const float bv = static_cast<float>(border);
  auto at = [&](int yy, int xx, int c) -> float {
    if (yy < 0 || yy >= sh || xx < 0 || xx >= sw) return bv;
    return static_cast<float>(src[static_cast<int64_t>(yy) * sstride + 3 * xx + c]);
  };
  for (int y = 0; y < dh; y++) {
    const float fy = static_cast<float>(y);
    const float row_x = fy * m[1] + m[2], row_y = fy * m[4] + m[5];
    uint8_t* o = dst + static_cast<int64_t>(y) * dw * 3;
    for (int x = 0; x < dw; x++) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < vec_end) {
        sx = std::fmaf(m[0], fx, row_x);
        sy = std::fmaf(m[3], fx, row_y);
      } else {
        sx = std::fmaf(fx, m[0], fy * m[1]) + m[2];
        sy = std::fmaf(fx, m[3], fy * m[4]) + m[5];
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      if (!(flx >= -2.f && flx <= sw + 1.f && fly >= -2.f && fly <= sh + 1.f)) {
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = sat_u8(border);   // every neighbour outside
        continue;
      }
      const int ix = static_cast<int>(flx), iy = static_cast<int>(fly);
      const float alpha = sx - flx, beta = sy - fly;
      for (int c = 0; c < 3; c++) {
        const float p00 = at(iy, ix, c), p01 = at(iy, ix + 1, c);
        const float p10 = at(iy + 1, ix, c), p11 = at(iy + 1, ix + 1, c);
        const float q0 = std::fmaf(alpha, p01 - p00, p00);
        const float q1 = std::fmaf(alpha, p11 - p10, p10);
        const float v = std::nearbyint(std::fmaf(beta, q1 - q0, q0));
        o[3 * x + c] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
      }
    }
  }
}

// ------------------------------------------------------------ encode ----
// cv2.imencode(".jpg", img) at its defaults, as libjpeg-turbo 3.1.2 writes
// it: quality 95 (jpeg_set_quality, baseline-forced tables), YCbCr 4:2:0,
// the islow forward DCT, the standard Huffman tables (no optimisation), one
// interleaved baseline scan, no restart markers, a JFIF 1.01 APP0 (no
// density unit, 1:1) and nothing else. Its SIMD routines (colour
// conversion, h2v2 downsampling, FDCT, reciprocal quantisation) compute what
// the C routines below compute.

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kQuality = 95;

// jpeg_set_quality(95, force_baseline): scale 200 - 2 q percent, 1..255
void scaled_quant(const uint8_t* base, uint16_t* q) {
  const long scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (static_cast<long>(base[i]) * scale + 50) / 100;
    q[i] = static_cast<uint16_t>(t <= 0 ? 1 : (t > 255 ? 255 : t));
  }
}

// jcdctmgr.c compute_reciprocal for a divisor of 16 bits (DCTELEM short)
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of (|x| + corr) * recip
};

Divisor reciprocal(uint32_t d) {
  int b = 0;
  while ((d >> (b + 1)) != 0) b++;  // flss(d) - 1
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((uint64_t{1} << r) / d);
  const uint32_t fr = static_cast<uint32_t>((uint64_t{1} << r) % d);
  uint32_t c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= d / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jpeg_fdct_islow on 64 samples already centred (natural order), in place
void fdct_islow(int32_t* data) {
  constexpr int kB = kConstBits, kP = kPass1Bits;
  auto descale = [](int64_t x, int n) { return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;  // element step along a row / a column
    const int line = pass == 0 ? 8 : 1;
    for (int ctr = 0; ctr < 8; ctr++) {
      int32_t* d = data + ctr * line;
      const int64_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      const int64_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      const int64_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      const int64_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass == 0 ? kB - kP : kB + kP;
      if (pass == 0) {
        d[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << kP));
        d[4 * step] = static_cast<int32_t>((tmp10 - tmp11) * (1 << kP));
      } else {
        d[0] = descale(tmp10 + tmp11, kP);
        d[4 * step] = descale(tmp10 - tmp11, kP);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * step] = descale(z1 + tmp13 * F0765, sh);
      d[6 * step] = descale(z1 - tmp12 * int64_t{F1847}, sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1175;
      const int64_t t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072, t7 = tmp7 * F1501;
      z1 *= -int64_t{F0899};
      z2 *= -int64_t{F2562};
      z3 = z3 * -int64_t{F1961} + z5;
      z4 = z4 * -int64_t{F0390} + z5;
      d[7 * step] = descale(t4 + z1 + z3, sh);
      d[5 * step] = descale(t5 + z2 + z4, sh);
      d[3 * step] = descale(t6 + z2 + z3, sh);
      d[step] = descale(t7 + z1 + z4, sh);
    }
  }
}

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

// jpeg_make_c_derived_tbl: canonical codes from the counts
HuffEnc derive(const uint8_t* bits, const uint8_t* vals) {
  HuffEnc h{};
  int k = 0;
  uint32_t code = 0;
  for (int len = 1; len <= 16; len++) {
    for (int i = 0; i < bits[len - 1]; i++, k++) {
      h.code[vals[k]] = static_cast<uint16_t>(code++);
      h.size[vals[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
  return h;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t v, int n) {  // the low n bits of v, n <= 16
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {  // pad with 1-bits to a byte
    if (nbits > 0) put(0x7F, 8 - nbits);
  }
};

// jchuff.c encode_one_block: the DC difference, then AC runs (ZRL, EOB)
void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffEnc& dc,
                  const HuffEnc& ac) {
  int t = blk[0] - last_dc, t2 = t;
  last_dc = blk[0];
  if (t < 0) {
    t = -t;
    t2--;
  }
  int nb = 0;
  while (t) {
    nb++;
    t >>= 1;
  }
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(t2), nb);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    t = blk[kNatural[k]];
    if (t == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    t2 = t;
    if (t < 0) {
      t = -t;
      t2--;
    }
    nb = 1;
    while ((t >>= 1)) nb++;
    const int sym = (r << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(t2), nb);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v));
}

void put_dqt(std::vector<uint8_t>& o, int id, const uint16_t* q) {
  o.insert(o.end(), {0xFF, 0xDB});
  put16(o, 67);
  o.push_back(static_cast<uint8_t>(id));
  for (int i = 0; i < 64; i++) o.push_back(static_cast<uint8_t>(q[kNatural[i]]));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += bits[i];
  o.insert(o.end(), {0xFF, 0xC4});
  put16(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(cls_id));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

// BGR (h, w, 3), rows `stride` bytes apart -> the JPEG file's bytes.
std::vector<uint8_t> jpeg_encode(const uint8_t* img, int h, int w, int64_t stride) {
  // colour conversion (jccolor.c's tables), planes padded as jcprepct.c /
  // jcsample.c pad them: Y to ceil(w/8)*8 columns and the iMCU height by
  // replicating the last column and row; the full-resolution chroma to
  // ceil(w/16)*16 columns and an even row count before the h2v2 average
  // (bias 1, 2, 1, 2 ... along each row), its output to the iMCU height.
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y blocks a row / a column
  const int yw = mcux * 16, yh = mcuy * 16, cw = mcux * 8, ch = mcuy * 8;
  std::vector<uint8_t> Y(static_cast<size_t>(yw) * yh), Cb(static_cast<size_t>(cw) * ch),
      Cr(static_cast<size_t>(cw) * ch);
  {
    constexpr int64_t kHalf = int64_t{1} << 15, kOff = int64_t{128} << 16;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536 + 0.5); };
    const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int64_t rcb = -fix(0.16874), gcb = -fix(0.33126), half = fix(0.5);
    const int64_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    const int rows = h + (h & 1);            // chroma's even row count
    const int cols = mcux * 16;              // chroma's padded width
    std::vector<uint8_t> fcb(static_cast<size_t>(cols) * rows), fcr(fcb.size());
    for (int y = 0; y < rows; y++) {
      const uint8_t* src = img + static_cast<int64_t>(std::min(y, h - 1)) * stride;
      for (int x = 0; x < cols; x++) {
        const uint8_t* p = src + 3 * std::min(x, w - 1);
        const int64_t b = p[0], g = p[1], r = p[2];
        if (y < h && x < ybw * 8)
          Y[static_cast<size_t>(y) * yw + x] =
              static_cast<uint8_t>((ry * r + gy * g + by * b + kHalf) >> 16);
        fcb[static_cast<size_t>(y) * cols + x] =
            static_cast<uint8_t>((rcb * r + gcb * g + half * b + kOff + kHalf - 1) >> 16);
        fcr[static_cast<size_t>(y) * cols + x] =
            static_cast<uint8_t>((half * r + gcr * g + bcr * b + kOff + kHalf - 1) >> 16);
      }
    }
    for (int y = h; y < yh; y++)
      std::memcpy(&Y[static_cast<size_t>(y) * yw], &Y[static_cast<size_t>(h - 1) * yw], yw);
    const int crows = rows / 2;
    for (int y = 0; y < ch; y++) {
      const int sy = std::min(y, crows - 1);
      const uint8_t* b0 = &fcb[static_cast<size_t>(2 * sy) * cols];
      const uint8_t* r0 = &fcr[static_cast<size_t>(2 * sy) * cols];
      for (int x = 0, bias = 1; x < cw; x++, bias ^= 3) {
        const int i = 2 * x;
        Cb[static_cast<size_t>(y) * cw + x] =
            static_cast<uint8_t>((b0[i] + b0[i + 1] + b0[i + cols] + b0[i + cols + 1] + bias) >> 2);
        Cr[static_cast<size_t>(y) * cw + x] =
            static_cast<uint8_t>((r0[i] + r0[i + 1] + r0[i + cols] + r0[i + cols + 1] + bias) >> 2);
      }
    }
  }
  uint16_t qy[64], qc[64];
  scaled_quant(kStdLumQ, qy);
  scaled_quant(kStdChromQ, qc);
  Divisor dy[64], dc[64];
  for (int i = 0; i < 64; i++) {
    dy[i] = reciprocal(uint32_t{qy[i]} << 3);
    dc[i] = reciprocal(uint32_t{qc[i]} << 3);
  }
  // one block: samples - 128, FDCT, quantise (natural order)
  auto block = [](const uint8_t* plane, int pw, int bx, int by, const Divisor* dv, int16_t* out) {
    int32_t ws[64];
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++)
        ws[r * 8 + c] = plane[static_cast<size_t>(by * 8 + r) * pw + bx * 8 + c] - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) {
      const uint32_t a = static_cast<uint32_t>(ws[i] < 0 ? -ws[i] : ws[i]);
      const int v = static_cast<int>((uint64_t{a + dv[i].corr} * dv[i].recip) >> dv[i].shift);
      out[i] = static_cast<int16_t>(ws[i] < 0 ? -v : v);
    }
  };

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                     0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
  put_dqt(o, 0, qy);
  put_dqt(o, 1, qc);
  o.insert(o.end(), {0xFF, 0xC0});
  put16(o, 17);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.insert(o.end(), {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  put_dht(o, 0x00, kDcLumBits, kDcVals);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals);
  put_dht(o, 0x01, kDcChromBits, kDcVals);
  put_dht(o, 0x11, kAcChromBits, kAcChromVals);
  o.insert(o.end(), {0xFF, 0xDA, 0x00, 0x0C, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  const HuffEnc hdy = derive(kDcLumBits, kDcVals), hay = derive(kAcLumBits, kAcLumVals);
  const HuffEnc hdc = derive(kDcChromBits, kDcVals), hac = derive(kAcChromBits, kAcChromVals);
  BitWriter bw{o};
  int ldy = 0, ldb = 0, ldr = 0;
  int16_t blk[4][64], cblk[64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      // jccoefct.c: a Y block right of the image's blocks is a dummy (zero
      // AC, the DC of the block to its left); a Y block row below them is
      // dummies with the DC of the MCU's block before it
      for (int yb = 0; yb < 2; yb++) {
        for (int xb = 0; xb < 2; xb++) {
          int16_t* b = blk[yb * 2 + xb];
          const int bx = 2 * mx + xb, by = 2 * my + yb;
          if (by >= ybh) {
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = blk[yb * 2 + xb - 1][0];
          } else if (bx >= ybw) {
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = blk[yb * 2 + xb - 1][0];
          } else {
            block(Y.data(), yw, bx, by, dy, b);
          }
        }
      }
      for (int i = 0; i < 4; i++) encode_block(bw, blk[i], ldy, hdy, hay);
      block(Cb.data(), cw, mx, my, dc, cblk);
      encode_block(bw, cblk, ldb, hdc, hac);
      block(Cr.data(), cw, mx, my, dc, cblk);
      encode_block(bw, cblk, ldr, hdc, hac);
    }
  }
  bw.flush();
  o.insert(o.end(), {0xFF, 0xD9});
  return o;
}

int report(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  return 1;
}

}  // namespace

// ------------------------------------------------------------ exports ----
extern "C" {

int tscd_bgr2hsv(const uint8_t* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; i++) bgr2hsv_px(src + 3 * i, dst + 3 * i);
  return 0;
}

// (rows, width, 3) contiguous; the row width decides which pixels take
// OpenCV's vector path.
int tscd_hsv2bgr(const uint8_t* src, uint8_t* dst, int64_t rows, int64_t width) {
  for (int64_t r = 0; r < rows; r++) hsv2bgr_row(src + 3 * r * width, dst + 3 * r * width, width);
  return 0;
}

// In place on (rows, width, 3): BGR -> HSV, H + hgain mod 180, S + sgain and
// V + vgain clipped to 0..255, HSV -> BGR (JAX's int16 arithmetic).
int tscd_hsv_jitter(uint8_t* img, int64_t rows, int64_t width, int hgain, int sgain,
                    int vgain) {
  std::vector<uint8_t> hsv(3 * width);
  for (int64_t r = 0; r < rows; r++) {
    uint8_t* row = img + 3 * r * width;
    for (int64_t i = 0; i < width; i++) {
      uint8_t* q = hsv.data() + 3 * i;
      bgr2hsv_px(row + 3 * i, q);
      int h = (static_cast<int>(q[0]) + hgain) % 180;
      q[0] = static_cast<uint8_t>(h < 0 ? h + 180 : h);
      q[1] = sat_u8(static_cast<int>(q[1]) + sgain);
      q[2] = sat_u8(static_cast<int>(q[2]) + vgain);
    }
    hsv2bgr_row(hsv.data(), row, width);
  }
  return 0;
}

// src (sh, sw, cn) rows `sstride` bytes apart -> dst (dh, dw, cn), contiguous.
int tscd_resize_linear(const uint8_t* src, int sh, int sw, int64_t sstride,
                       uint8_t* dst, int dh, int dw, int cn) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  resize_linear(src, sh, sw, sstride, dst, dh, dw, cn);
  return 0;
}

// The same call on the image as float32 -> dst (dh, dw, cn) float32; 1
// outside the sizes held to cv2 (sources under 2 px a side, more than 8x
// wider).
int tscd_resize_linear_f32(const uint8_t* src, int sh, int sw, int64_t sstride,
                           float* dst, int dh, int dw, int cn) {
  if (sh < 2 || sw < 2 || dh <= 0 || dw <= 0 || cn <= 0 || dw > 8 * sw) return 1;
  resize_linear_f32(src, sh, sw, sstride, dst, dh, dw, cn);
  return 0;
}

// cv2.warpAffine(src (sh, sw, 3), M (2 x 3, row major), (dw, dh),
// borderValue=(border,) * 3) -> dst (dh, dw, 3); 1 for an empty size or a
// border outside 0..255.
int tscd_warp_affine(const uint8_t* src, int sh, int sw, int64_t sstride, uint8_t* dst, int dh,
                     int dw, const double* M, int border) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || border < 0 || border > 255) return 1;
  warp_affine_linear(src, sh, sw, sstride, dst, dh, dw, M, border);
  return 0;
}

// The frame's size, with the checks of a decode: 0, or 1 with the reason in
// `err`.
int tscd_jpeg_info(const uint8_t* data, int64_t len, int* height, int* width, char* err,
                   int errlen) {
  try {
    Jpeg j;
    parse_header(j, data, static_cast<size_t>(len));
    check_supported(j);
    *height = j.height;
    *width = j.width;
    return 0;
  } catch (const JpegError& e) {
    return report(e.msg, err, errlen);
  }
}

// Decodes into out (height, width, 3) BGR, the size tscd_jpeg_info gave.
int tscd_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int height, int width,
                     char* err, int errlen) {
  try {
    Jpeg j;
    parse_header(j, data, static_cast<size_t>(len));
    check_supported(j);
    if (j.height != height || j.width != width) fail("output size differs from the frame's");
    decode_scan(j, data, static_cast<size_t>(len));
    to_bgr(j, out);
    return 0;
  } catch (const JpegError& e) {
    return report(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, errlen);
  }
}

// cv2.imencode(".jpg", img) of a BGR (height, width, 3) image with rows
// `stride` bytes apart, into out[0, cap); *len gets the file's size. 1 with
// the reason in `err` where it does not fit (call again with *len bytes).
int tscd_jpeg_encode(const uint8_t* img, int height, int width, int64_t stride, uint8_t* out,
                     int64_t cap, int64_t* len, char* err, int errlen) {
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535)
    return report("a JPEG's sides are 1 to 65535 pixels", err, errlen);
  try {
    const std::vector<uint8_t> o = jpeg_encode(img, height, width, stride);
    *len = static_cast<int64_t>(o.size());
    if (*len > cap) return report("output buffer too small", err, errlen);
    std::memcpy(out, o.data(), o.size());
    return 0;
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, errlen);
  }
}

}  // extern "C"
