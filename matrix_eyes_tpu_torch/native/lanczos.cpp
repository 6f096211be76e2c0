// The PyTorch port's copy of matrix_eyes_tpu/native/lanczos.cpp, built by
// matrix_eyes_tpu_torch/native/__init__.py.
//
// Host-side Lanczos3 RGB8 resize, image-crate semantics
// (reference: image-0.25 imageops/sample.rs horizontal_sample /
// vertical_sample, as used by output.rs:133-137 resize_exact).
//
// Why this exists: the depth-map PNG path colours at GRID resolution
// (1536^2, 7 MB as u8 RGB) and upsizes to the source photo (12 MP,
// 36 MB). Doing the upsize on device means reading 36 MB back over the
// device link per image; doing it HERE means reading 7 MB and spending
// ~60 ms of multi-core host arithmetic -- a ~5x cut in the transfer
// floor that dominates the depth-map e2e (bench.py, docs/PERFORMANCE.md).
//
// Parity: taps, weights and accumulation order mirror the image crate
// exactly -- per output pixel the taps accumulate SEQUENTIALLY in f32
// (the k-outer loop below keeps that per-pixel order while vectorising
// across the row), centre = (o + 0.5) * ratio, support = 3 * sratio,
// window clamped like ops/resize.py::_lanczos3_matrix, weights
// normalised by their f32 sum, vertical pass then horizontal pass, one
// final round-half-away + clamp to u8 (FloatNearest).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct AxisTaps {
  // flattened per-output-index tap windows
  std::vector<int64_t> left;
  std::vector<int32_t> len;
  std::vector<float> weights;  // offsets o * max_len
  int64_t max_len = 0;
};

inline float lanczos3(float x) {
  if (x == 0.0f) return 1.0f;
  if (x <= -3.0f || x >= 3.0f) return 0.0f;
  float t = static_cast<float>(M_PI) * x;
  float t3 = t / 3.0f;
  return (std::sin(t) / t) * (std::sin(t3) / t3);
}

AxisTaps build_taps(int64_t n_in, int64_t n_out) {
  AxisTaps a;
  const double ratio = static_cast<double>(n_in) / static_cast<double>(n_out);
  const double sratio = ratio > 1.0 ? ratio : 1.0;
  const double support = 3.0 * sratio;
  a.max_len = static_cast<int64_t>(std::ceil(2.0 * support)) + 2;
  a.left.resize(n_out);
  a.len.resize(n_out);
  a.weights.assign(static_cast<size_t>(n_out * a.max_len), 0.0f);
  for (int64_t o = 0; o < n_out; ++o) {
    const double center = (static_cast<double>(o) + 0.5) * ratio;
    int64_t left = static_cast<int64_t>(std::floor(center - support));
    if (left < 0) left = 0;
    if (left > n_in - 1) left = n_in - 1;
    int64_t right = static_cast<int64_t>(std::ceil(center + support));
    if (right < left + 1) right = left + 1;
    if (right > n_in) right = n_in;
    float* w = &a.weights[static_cast<size_t>(o * a.max_len)];
    float sum = 0.0f;
    for (int64_t k = left; k < right; ++k) {
      const float x =
          static_cast<float>((static_cast<double>(k) + 0.5 - center) / sratio);
      w[k - left] = lanczos3(x);
      sum += w[k - left];
    }
    if (sum != 0.0f) {
      for (int64_t k = 0; k < right - left; ++k) w[k] /= sum;
    }
    a.left[o] = left;
    a.len[o] = static_cast<int32_t>(right - left);
  }
  return a;
}

inline uint8_t to_u8(float v) {
  // round-half-away (values are non-negative) + clamp, the image crate's
  // FloatNearest conversion (ops/resize.py::to_u8)
  float r = std::floor(v + 0.5f);
  if (r < 0.0f) r = 0.0f;
  if (r > 255.0f) r = 255.0f;
  return static_cast<uint8_t>(r);
}

void run_striped(int64_t n, int n_threads, void (*fn)(int64_t, int64_t, void*),
                 void* ctx) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t t = n_threads > 0 ? n_threads : (hw ? hw : 1);
  if (t > n) t = n;
  if (t <= 1) {
    fn(0, n, ctx);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(t));
  const int64_t chunk = (n + t - 1) / t;
  for (int64_t i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi, ctx); });
  }
  for (auto& th : pool) th.join();
}

struct VerticalCtx {
  const uint8_t* in;
  float* tmp;
  const AxisTaps* taps;
  int64_t row_elems;  // in_w * 3
};

void vertical_stripe(int64_t lo, int64_t hi, void* p) {
  auto* c = static_cast<VerticalCtx*>(p);
  const int64_t re = c->row_elems;
  for (int64_t o = lo; o < hi; ++o) {
    float* dst = c->tmp + o * re;
    std::memset(dst, 0, static_cast<size_t>(re) * sizeof(float));
    const float* w = &c->taps->weights[static_cast<size_t>(o * c->taps->max_len)];
    const int64_t left = c->taps->left[o];
    const int32_t len = c->taps->len[o];
    // k-outer / j-inner: vectorises across the row while keeping each
    // pixel's tap accumulation in the image crate's sequential order
    for (int32_t k = 0; k < len; ++k) {
      const float wk = w[k];
      const uint8_t* src = c->in + (left + k) * re;
      for (int64_t j = 0; j < re; ++j) dst[j] += wk * static_cast<float>(src[j]);
    }
  }
}

struct HorizontalCtx {
  const float* tmp;
  uint8_t* out;
  const AxisTaps* taps;
  int64_t in_w;
  int64_t out_w;
};

void horizontal_stripe(int64_t lo, int64_t hi, void* p) {
  auto* c = static_cast<HorizontalCtx*>(p);
  for (int64_t row = lo; row < hi; ++row) {
    const float* src = c->tmp + row * c->in_w * 3;
    uint8_t* dst = c->out + row * c->out_w * 3;
    for (int64_t o = 0; o < c->out_w; ++o) {
      const float* w =
          &c->taps->weights[static_cast<size_t>(o * c->taps->max_len)];
      const int64_t left = c->taps->left[o];
      const int32_t len = c->taps->len[o];
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
      const float* s = src + left * 3;
      for (int32_t k = 0; k < len; ++k) {
        const float wk = w[k];
        acc0 += wk * s[3 * k + 0];
        acc1 += wk * s[3 * k + 1];
        acc2 += wk * s[3 * k + 2];
      }
      dst[3 * o + 0] = to_u8(acc0);
      dst[3 * o + 1] = to_u8(acc1);
      dst[3 * o + 2] = to_u8(acc2);
    }
  }
}

}  // namespace

extern "C" int me_lanczos3_rgb8(const uint8_t* in, int64_t in_h, int64_t in_w,
                                uint8_t* out, int64_t out_h, int64_t out_w,
                                int n_threads) {
  if (!in || !out || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0)
    return 1;
  if (in_h == out_h && in_w == out_w) {
    // equal sizes: every centre lands on a pixel, the kernel is exact
    // identity -- skip the arithmetic (and its rounding) entirely
    std::memcpy(out, in, static_cast<size_t>(in_h * in_w * 3));
    return 0;
  }
  try {
    const AxisTaps vt = build_taps(in_h, out_h);
    const AxisTaps ht = build_taps(in_w, out_w);
    std::vector<float> tmp(static_cast<size_t>(out_h * in_w * 3));
    VerticalCtx vc{in, tmp.data(), &vt, in_w * 3};
    run_striped(out_h, n_threads, vertical_stripe, &vc);
    HorizontalCtx hc{tmp.data(), out, &ht, in_w, out_w};
    run_striped(out_h, n_threads, horizontal_stripe, &hc);
  } catch (...) {
    return 2;
  }
  return 0;
}
