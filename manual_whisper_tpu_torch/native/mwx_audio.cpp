// mwx_audio — native audio frontend of manual_whisper_tpu_torch (a copy of
// manual_whisper_tpu/native/mwx_audio.cpp, same C ABI; built by the port's
// audio/native.py into _kernels/).
//
// Role parity: the reference's audio decode path is native C (ffmpeg via
// whisperx.load_audio, reference: transcribe.py:117).  This library is the
// TPU build's native equivalent for the formats we own end-to-end:
// RIFF/WAVE parsing (PCM 8/16/24/32, float32/64) to mono float32 and a
// Kaiser-windowed polyphase sinc resampler matching audio/resample.py.
//
// C ABI only; bound from Python with ctypes (audio/native.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kHalfWidth = 24;

double bessel_i0(double x) {
  // Series expansion; converges quickly for the Kaiser betas we use.
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

double kaiser(double t, double half_width, double beta) {
  // t in [-half_width, half_width]
  double r = t / half_width;
  if (r < -1.0 || r > 1.0) return 0.0;
  return bessel_i0(beta * std::sqrt(1.0 - r * r)) / bessel_i0(beta);
}

double sinc(double x) {
  if (x == 0.0) return 1.0;
  double px = M_PI * x;
  return std::sin(px) / px;
}

uint64_t gcd_u64(uint64_t a, uint64_t b) {
  while (b) { uint64_t t = a % b; a = b; b = t; }
  return a;
}

}  // namespace

extern "C" {

void mwx_free(void* p) { std::free(p); }

// Decode a RIFF/WAVE blob to mono float32.
// Returns 0 on success; *out is malloc'd (caller frees with mwx_free).
int mwx_decode_wav(const uint8_t* data, uint64_t len, float** out,
                   int64_t* out_len, int32_t* sample_rate) {
  if (!data || len < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0) {
    return -1;
  }
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* raw = nullptr;
  uint64_t raw_len = 0;

  uint64_t pos = 12;
  while (pos + 8 <= len) {
    uint32_t chunk_size;
    std::memcpy(&chunk_size, data + pos + 4, 4);
    uint64_t body = pos + 8;
    if (body + chunk_size > len) chunk_size = (uint32_t)(len - body);
    if (std::memcmp(data + pos, "fmt ", 4) == 0 && chunk_size >= 16) {
      std::memcpy(&audio_format, data + body, 2);
      std::memcpy(&channels, data + body + 2, 2);
      std::memcpy(&sr, data + body + 4, 4);
      std::memcpy(&bits, data + body + 14, 2);
      if (audio_format == 0xFFFE && chunk_size >= 26) {
        uint16_t sub;
        std::memcpy(&sub, data + body + 24, 2);
        audio_format = sub;
      }
    } else if (std::memcmp(data + pos, "data", 4) == 0) {
      raw = data + body;
      raw_len = chunk_size;
    }
    pos = body + chunk_size + (chunk_size & 1);
  }
  if (!raw || channels == 0 || sr == 0) return -2;

  uint64_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) return -3;
  uint64_t n_total = raw_len / bytes_per_sample;
  uint64_t n_frames = n_total / channels;
  float* mono = (float*)std::malloc(sizeof(float) * (n_frames ? n_frames : 1));
  if (!mono) return -4;

  for (uint64_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (uint16_t c = 0; c < channels; ++c) {
      uint64_t s = i * channels + c;
      const uint8_t* p = raw + s * bytes_per_sample;
      double v = 0.0;
      if (audio_format == 1) {  // PCM int
        if (bits == 16) {
          int16_t x; std::memcpy(&x, p, 2); v = x / 32768.0;
        } else if (bits == 32) {
          int32_t x; std::memcpy(&x, p, 4); v = x / 2147483648.0;
        } else if (bits == 24) {
          int32_t x = p[0] | (p[1] << 8) | (p[2] << 16);
          if (x >= (1 << 23)) x -= (1 << 24);
          v = x / 8388608.0;
        } else if (bits == 8) {
          v = ((double)p[0] - 128.0) / 128.0;
        } else { std::free(mono); return -5; }
      } else if (audio_format == 3) {  // IEEE float
        if (bits == 32) {
          float x; std::memcpy(&x, p, 4); v = x;
        } else if (bits == 64) {
          double x; std::memcpy(&x, p, 8); v = x;
        } else { std::free(mono); return -5; }
      } else { std::free(mono); return -6; }
      acc += v;
    }
    mono[i] = (float)(acc / channels);
  }
  *out = mono;
  *out_len = (int64_t)n_frames;
  *sample_rate = (int32_t)sr;
  return 0;
}

// Polyphase windowed-sinc resampler (same filter design as
// audio/resample.py: Kaiser beta 8.555, 48 taps, unity-DC normalised).
int mwx_resample(const float* in, int64_t n, int32_t sr_in, int32_t sr_out,
                 float** out, int64_t* out_n) {
  if (!in || n < 0 || sr_in <= 0 || sr_out <= 0) return -1;
  if (sr_in == sr_out || n == 0) {
    float* y = (float*)std::malloc(sizeof(float) * (n ? n : 1));
    if (!y) return -4;
    std::memcpy(y, in, sizeof(float) * n);
    *out = y; *out_n = n;
    return 0;
  }
  uint64_t g = gcd_u64((uint64_t)sr_in, (uint64_t)sr_out);
  int64_t up = sr_out / (int64_t)g, down = sr_in / (int64_t)g;
  double cutoff = up < down ? (double)up / (double)down : 1.0;
  const double beta = 8.555;
  const int taps = 2 * kHalfWidth;

  // Filter bank: one row per phase.
  std::vector<double> bank((size_t)up * taps);
  for (int64_t phase = 0; phase < up; ++phase) {
    double frac = (double)phase / (double)up;
    double sum = 0.0;
    for (int k = 0; k < taps; ++k) {
      double t = (double)(k - kHalfWidth) - frac + 1.0;
      double w = sinc(t * cutoff) * cutoff * kaiser(t, kHalfWidth, beta);
      bank[(size_t)phase * taps + k] = w;
      sum += w;
    }
    if (std::abs(sum) > 1e-12) {
      for (int k = 0; k < taps; ++k) bank[(size_t)phase * taps + k] /= sum;
    }
  }

  int64_t n_out = (n * up + down - 1) / down;
  float* y = (float*)std::malloc(sizeof(float) * (n_out ? n_out : 1));
  if (!y) return -4;

  for (int64_t j = 0; j < n_out; ++j) {
    int64_t pos_num = j * down;
    int64_t base = pos_num / up;
    int64_t phase = pos_num % up;
    const double* w = &bank[(size_t)phase * taps];
    double acc = 0.0;
    for (int k = 0; k < taps; ++k) {
      int64_t idx = base + (k - kHalfWidth + 1);
      if (idx >= 0 && idx < n) acc += w[k] * in[idx];
    }
    y[j] = (float)acc;
  }
  *out = y;
  *out_n = n_out;
  return 0;
}

}  // extern "C"
