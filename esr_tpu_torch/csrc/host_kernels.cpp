// Native host kernels of the event data path: the port's own copy of
// esr_tpu/native/host_kernels.cpp, built with g++ at first use by
// esr_tpu_torch/native.py and called through ctypes (which releases the
// GIL for the call, so loader threads rasterize in parallel).
//
// All kernels are single-pass, allocate nothing, and drop out-of-range
// events as the numpy twins in esr_tpu_torch/data/np_encodings.py do.
// Polarity weights are small integers, so float accumulation is exact and
// matches the numpy (bincount) and torch (index_put_ accumulate) paths
// bitwise.

#include <cmath>
#include <cstdint>

extern "C" {

// Two-channel count image: out[h][w][2], channel 0 = positive counts,
// channel 1 = negative counts (np_encodings.events_to_channels_np).
void rasterize_counts(const float* xs, const float* ys, const float* ps,
                      int64_t n, int64_t h, int64_t w, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    // bounds checked on the FLOAT coordinates (numpy-mirror semantics: the
    // mask precedes the truncating cast, so -0.5 is dropped, not clamped)
    if (xs[i] < 0.f || xs[i] >= (float)w || ys[i] < 0.f || ys[i] >= (float)h)
      continue;
    const int64_t x = (int64_t)xs[i];
    const int64_t y = (int64_t)ys[i];
    const int64_t base = (y * w + x) * 2;
    if (ps[i] > 0.f) {
      out[base] += 1.f;
    } else if (ps[i] < 0.f) {
      out[base + 1] += 1.f;
    }
  }
}

// Signed time-binned stack: out[h][w][bins], half-open binning
// bin = floor((t - t0) / (t1 - t0 + 1e-6) * bins), clipped
// (np_encodings.events_to_stack_np).
void rasterize_stack(const float* xs, const float* ys, const float* ts,
                     const float* ps, int64_t n, int64_t bins, int64_t h,
                     int64_t w, float* out) {
  if (n == 0) return;
  float t0 = ts[0], t1 = ts[0];
  for (int64_t i = 1; i < n; ++i) {
    if (ts[i] < t0) t0 = ts[i];
    if (ts[i] > t1) t1 = ts[i];
  }
  const float dt = t1 - t0 + 1e-6f;
  for (int64_t i = 0; i < n; ++i) {
    if (xs[i] < 0.f || xs[i] >= (float)w || ys[i] < 0.f || ys[i] >= (float)h)
      continue;
    const int64_t x = (int64_t)xs[i];
    const int64_t y = (int64_t)ys[i];
    int64_t b = (int64_t)std::floor((ts[i] - t0) / dt * (float)bins);
    if (b < 0) b = 0;
    if (b >= bins) b = bins - 1;
    out[(y * w + x) * bins + b] += ps[i];
  }
}

// Fused renormalize-and-scatter: events with coordinates normalized to
// [0, 1) are scaled onto an (h, w) grid and count-rasterized in one pass
// (coordinates multiplied by the target resolution, floored by the int
// cast, then scattered).
void rescatter_counts(const float* xs_norm, const float* ys_norm,
                      const float* ps, int64_t n, int64_t h, int64_t w,
                      float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float xf = xs_norm[i] * (float)w;
    const float yf = ys_norm[i] * (float)h;
    if (xf < 0.f || xf >= (float)w || yf < 0.f || yf >= (float)h) continue;
    const int64_t x = (int64_t)xf;
    const int64_t y = (int64_t)yf;
    const int64_t base = (y * w + x) * 2;
    if (ps[i] > 0.f) {
      out[base] += 1.f;
    } else if (ps[i] < 0.f) {
      out[base + 1] += 1.f;
    }
  }
}

// Batched count rasterization with per-item offsets, parallel over items.
// xs/ys/ps are the concatenation of all items' events; offsets[i]..offsets[i+1]
// delimit item i. out is [items][h][w][2], zero-initialized by the caller.
void rasterize_counts_batch(const float* xs, const float* ys, const float* ps,
                            const int64_t* offsets, int64_t items, int64_t h,
                            int64_t w, float* out) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t it = 0; it < items; ++it) {
    rasterize_counts(xs + offsets[it], ys + offsets[it], ps + offsets[it],
                     offsets[it + 1] - offsets[it], h, w,
                     out + it * h * w * 2);
  }
}

}  // extern "C"
