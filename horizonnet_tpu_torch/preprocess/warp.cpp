// Wrap-bilinear image warp for the host preprocess path.
//
// Single tight loop replacing the numpy 4-tap gather in
// host_resample._gather_mix: per output pixel, floor the (py, px) sample
// coordinate, wrap-address the 4 neighbour taps with period-N modulo
// (matching ops/resample.bilinear_wrap_sample — true periodic image, not
// scipy's period N-1), and lerp in f32. The numpy version materializes
// four full gathered copies of the image per warp (~48 MB of traffic for
// a 512x1024x6 rotation); this loop touches each output pixel once and
// runs in ~10 ms on one core.
//
// Two entry points: f32 output (view-cut luma for LSD) and uint8 output
// with floor quantization (VP-aligned PNG path, matching
// rotate.rotate_panorama_uint8's device semantics: clip(floor(v),0,255)).
// Weight association matches host_resample._bilinear_wrap_tables:
// w11 = wy*wx, w10 = wy-w11, w01 = wx-w11, w00 = 1-wy-w01 — kept
// expression-identical (and compiled with -ffp-contract=off) so the C++
// and numpy fallback paths agree to f32 rounding.

#include <cmath>
#include <cstdint>

namespace {

inline int wrap(long i, int n) {
  long m = i % n;
  return static_cast<int>(m < 0 ? m + n : m);
}

struct Taps {
  long i00, i01, i10, i11;
  float w00, w01, w10, w11;
};

inline Taps taps_at(float py, float px, int H, int W) {
  float y0f = std::floor(py);
  float x0f = std::floor(px);
  float wy = py - y0f;
  float wx = px - x0f;
  int y0 = wrap(static_cast<long>(y0f), H);
  int y1 = y0 + 1 == H ? 0 : y0 + 1;
  int x0 = wrap(static_cast<long>(x0f), W);
  int x1 = x0 + 1 == W ? 0 : x0 + 1;
  Taps t;
  t.i00 = static_cast<long>(y0) * W + x0;
  t.i01 = static_cast<long>(y0) * W + x1;
  t.i10 = static_cast<long>(y1) * W + x0;
  t.i11 = static_cast<long>(y1) * W + x1;
  t.w11 = wy * wx;
  t.w10 = wy - t.w11;
  t.w01 = wx - t.w11;
  t.w00 = 1.0f - wy - t.w01;
  return t;
}

}  // namespace

extern "C" {

// img: [H*W, C] f32 row-major; py/px: [N] f32; out: [N, C] f32.
void warp_bilinear_wrap_f32(const float* img, int H, int W, int C,
                            const float* py, const float* px, long N,
                            float* out) {
  for (long i = 0; i < N; ++i) {
    Taps t = taps_at(py[i], px[i], H, W);
    const float* p00 = img + t.i00 * C;
    const float* p01 = img + t.i01 * C;
    const float* p10 = img + t.i10 * C;
    const float* p11 = img + t.i11 * C;
    float* o = out + i * C;
    for (int c = 0; c < C; ++c) {
      o[c] = p00[c] * t.w00 + p01[c] * t.w01 + p10[c] * t.w10 +
             p11[c] * t.w11;
    }
  }
}

// img: [H*W, C] uint8; out: [N, C] uint8, floor-quantized like the
// device path (rotate.rotate_panorama_uint8).
void warp_bilinear_wrap_u8(const uint8_t* img, int H, int W, int C,
                           const float* py, const float* px, long N,
                           uint8_t* out) {
  for (long i = 0; i < N; ++i) {
    Taps t = taps_at(py[i], px[i], H, W);
    const uint8_t* p00 = img + t.i00 * C;
    const uint8_t* p01 = img + t.i01 * C;
    const uint8_t* p10 = img + t.i10 * C;
    const uint8_t* p11 = img + t.i11 * C;
    uint8_t* o = out + i * C;
    for (int c = 0; c < C; ++c) {
      float v = static_cast<float>(p00[c]) * t.w00 +
                static_cast<float>(p01[c]) * t.w01 +
                static_cast<float>(p10[c]) * t.w10 +
                static_cast<float>(p11[c]) * t.w11;
      v = std::floor(v);
      o[c] = static_cast<uint8_t>(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
    }
  }
}

}  // extern "C"
