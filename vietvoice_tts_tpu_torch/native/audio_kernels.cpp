// Host-side audio DSP hot paths for the serving loop.
//
// The reference's native layer is ONNX Runtime (C++) executing its graphs
// (SURVEY §2); here the graph work runs in PyTorch and CUDA, and what remains
// hot on the host under high request rates is the post-processing done per
// response: clip repair, RMS-matched equal-power cross-fade concatenation
// (behavioral spec: vietvoicetts/core/audio_processor.py:
// 123-193). This library implements that path allocation-free over int16
// buffers; pipeline/audio.py falls back to numpy where the host has no g++.
//
// Built at first use by native/build.py (python -m vietvoice_tts_tpu_torch.native.build).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr float kInt16Max = 32767.0f;
constexpr float kClipRescale = 26214.0f;  // 80% of int16 range

// NaN-free by construction (int16 input); rescale in place when clipped.
void fix_clipped(int16_t* w, long long n, float* scratch_max) {
  int16_t max_abs = 0;
  for (long long i = 0; i < n; ++i) {
    int16_t a = static_cast<int16_t>(std::abs(static_cast<int>(w[i])));
    max_abs = std::max(max_abs, a);
  }
  *scratch_max = static_cast<float>(max_abs);
  if (max_abs >= kInt16Max) {
    const float scale = kClipRescale / static_cast<float>(max_abs);
    for (long long i = 0; i < n; ++i) {
      w[i] = static_cast<int16_t>(static_cast<float>(w[i]) * scale);
    }
  }
}

float rms(const int16_t* w, long long n) {
  double acc = 0.0;
  for (long long i = 0; i < n; ++i) {
    const double v = static_cast<double>(w[i]);
    acc += v * v;
  }
  return n > 0 ? static_cast<float>(std::sqrt(acc / static_cast<double>(n))) : 0.0f;
}

}  // namespace

extern "C" {

// Concatenate `n_waves` int16 buffers with RMS-matched cos^2/sin^2
// cross-fades of `crossfade_samples` (clamped per pair). `out` must hold
// sum(lengths). Returns the number of samples written.
long long vv_crossfade_concat(const int16_t** waves, const long long* lengths,
                              int n_waves, int crossfade_samples, int16_t* out) {
  if (n_waves <= 0) return 0;
  float scratch;

  // First wave: copy + clip-fix.
  long long out_len = lengths[0];
  std::memcpy(out, waves[0], sizeof(int16_t) * out_len);
  fix_clipped(out, out_len, &scratch);

  for (int i = 1; i < n_waves; ++i) {
    const long long next_len = lengths[i];
    // Clip-fix the incoming wave into the output tail region lazily: we
    // first need its (possibly rescaled) samples, so stage it at the end of
    // `out` (caller sized `out` to the no-overlap total, which is always
    // enough because overlaps only shrink the result).
    int16_t* next = out + out_len;
    std::memcpy(next, waves[i], sizeof(int16_t) * next_len);
    fix_clipped(next, next_len, &scratch);

    long long cf = std::min<long long>(crossfade_samples,
                                       std::min(out_len, next_len));
    if (cf <= 0) {
      out_len += next_len;
      continue;
    }

    int16_t* prev_tail = out + out_len - cf;
    const float prev_rms = rms(prev_tail, cf);
    float next_rms = rms(next, cf);
    float ratio = 1.0f;
    if (prev_rms > 100.0f && next_rms > 100.0f) {
      ratio = std::clamp(prev_rms / next_rms, 0.7f, 1.5f);
      if (ratio != 1.0f) {
        for (long long j = 0; j < next_len; ++j) {
          next[j] = static_cast<int16_t>(static_cast<float>(next[j]) * ratio);
        }
      }
    }

    // Equal-power overlap written into the prev tail, then shift the
    // remainder of `next` down to be contiguous.
    const float step = static_cast<float>(M_PI) * 0.5f /
                       static_cast<float>(cf > 1 ? cf - 1 : 1);
    for (long long j = 0; j < cf; ++j) {
      const float theta = step * static_cast<float>(j);
      const float c = std::cos(theta);
      const float s = std::sin(theta);
      const float mixed = static_cast<float>(prev_tail[j]) * c * c +
                          static_cast<float>(next[j]) * s * s;
      prev_tail[j] = static_cast<int16_t>(mixed);
    }
    std::memmove(out + out_len, next + cf, sizeof(int16_t) * (next_len - cf));
    out_len += next_len - cf;
  }
  return out_len;
}

// Peak-normalize float32 samples to 90% of int16 range after DC removal
// (behavioral spec: audio_processor.py:29-44).
void vv_normalize_to_int16(const float* in, long long n, int16_t* out) {
  if (n <= 0) return;
  double mean = 0.0;
  for (long long i = 0; i < n; ++i) mean += in[i];
  mean /= static_cast<double>(n);
  float max_abs = 0.0f;
  for (long long i = 0; i < n; ++i) {
    max_abs = std::max(max_abs, std::abs(static_cast<float>(in[i] - mean)));
  }
  const float scale = max_abs > 0.0f ? 29491.0f / max_abs : 0.0f;
  for (long long i = 0; i < n; ++i) {
    out[i] = static_cast<int16_t>((in[i] - mean) * scale);
  }
}

}  // extern "C"
