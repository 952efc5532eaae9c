// dpdfnet_host: native host-side audio runtime for DPDFNet-TPU.
//
// The reference framework leans on third-party native code for its host
// data path: libsndfile for WAV IO and librosa/soxr for resampling
// (SURVEY.md §2.9).  This library is the first-party TPU-framework
// equivalent: a C-ABI shared object exposing
//
//   - RIFF/WAVE read/write (PCM16 + float32),
//   - a windowed-sinc polyphase rational resampler (Kaiser beta 5.0,
//     matching scipy.signal.resample_poly's default filter design),
//   - 50%-overlap COLA overlap-add for the streaming engine.
//
// Loaded from Python over ctypes (dpdfnet_tpu/native.py); every entry
// point has a pure-NumPy fallback, so the .so is an optimisation, not a
// requirement.
//
// Build:  make -C native        (produces native/build/libdpdfnet_host.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// --------------------------------------------------------------------- //
// Resampler
// --------------------------------------------------------------------- //

static double bessel_i0(double x) {
  // Modified Bessel function of the first kind, order 0 (series expansion).
  double sum = 1.0, term = 1.0;
  const double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (static_cast<double>(k) * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// Design the polyphase prototype: kaiser-windowed sinc, identical
// parameterisation to scipy.signal.resample_poly (half_len = 10*max(up,down),
// cutoff = 1/max(up,down), beta = 5.0, gain = up).
static std::vector<double> design_filter(int up, int down) {
  const int max_rate = up > down ? up : down;
  const int half_len = 10 * max_rate;
  const int n_taps = 2 * half_len + 1;
  const double fc = 1.0 / max_rate;  // normalised cutoff (Nyquist = 1)
  const double beta = 5.0;
  std::vector<double> h(n_taps);
  const double i0b = bessel_i0(beta);
  for (int i = 0; i < n_taps; ++i) {
    const int m = i - half_len;
    const double t = static_cast<double>(m);
    double sinc = (m == 0) ? fc : std::sin(M_PI * fc * t) / (M_PI * t);
    const double r = t / half_len;
    const double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / i0b;
    h[i] = sinc * w * up;
  }
  return h;
}

// Number of output samples resample_poly produces.
int64_t dpdfnet_resample_out_len(int64_t n, int up, int down) {
  return (n * up + down - 1) / down;
}

// Rational polyphase resampling: x[n] float32 -> y[out_len] float32.
// Returns the number of samples written, or -1 on error.
int64_t dpdfnet_resample(const float* x, int64_t n, int up, int down,
                         float* y, int64_t y_cap) {
  if (n <= 0 || up <= 0 || down <= 0) return -1;
  const int64_t g = std::gcd(static_cast<int64_t>(up),
                             static_cast<int64_t>(down));
  up = static_cast<int>(up / g);
  down = static_cast<int>(down / g);
  const int64_t out_len = dpdfnet_resample_out_len(n, up, down);
  if (out_len > y_cap) return -1;
  if (up == 1 && down == 1) {
    std::memcpy(y, x, sizeof(float) * n);
    return n;
  }
  const std::vector<double> h = design_filter(up, down);
  const int n_taps = static_cast<int>(h.size());
  const int half_len = (n_taps - 1) / 2;

  // y[m] = sum_k h[k] * x_up[m*down - half_len + k] where x_up is the
  // zero-stuffed upsampled signal: x_up[i] = x[i/up] when i % up == 0.
  for (int64_t m = 0; m < out_len; ++m) {
    const int64_t pos = m * down - half_len;  // index into x_up
    // smallest k with (pos + k) % up == 0 and pos + k >= 0
    int64_t k0 = (pos >= 0) ? ((up - (pos % up)) % up) : (-pos);
    if (pos + k0 < 0) k0 += up * ((-(pos + k0) + up - 1) / up);
    double acc = 0.0;
    for (int64_t k = k0; k < n_taps; k += up) {
      const int64_t xi = (pos + k) / up;
      if (xi >= n) break;
      acc += h[k] * static_cast<double>(x[xi]);
    }
    y[m] = static_cast<float>(acc);
  }
  return out_len;
}

// --------------------------------------------------------------------- //
// Overlap-add commit (50% overlap COLA)
// --------------------------------------------------------------------- //

// frames: [T, win] windowed synthesis frames; tail: [hop] carried second
// half of the previous frame (updated in place); out: [T*hop].
void dpdfnet_ola_commit(const float* frames, int64_t T, int64_t win,
                        float* tail, float* out) {
  const int64_t hop = win / 2;
  for (int64_t t = 0; t < T; ++t) {
    const float* f = frames + t * win;
    float* o = out + t * hop;
    for (int64_t i = 0; i < hop; ++i) o[i] = f[i] + tail[i];
    std::memcpy(tail, f + hop, sizeof(float) * hop);
  }
}

// --------------------------------------------------------------------- //
// WAV IO (PCM16 / IEEE float32, mono or interleaved multichannel)
// --------------------------------------------------------------------- //

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;
  int32_t format;    // 1 = PCM, 3 = float
  int64_t frames;    // samples per channel
};

static bool read_chunk_header(FILE* f, char id[4], uint32_t* size) {
  if (std::fread(id, 1, 4, f) != 4) return false;
  if (std::fread(size, 4, 1, f) != 1) return false;
  return true;
}

// Probe a wav file; fills info. Returns 0 on success.
int dpdfnet_wav_info(const char* path, WavInfo* info) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char id[4];
  uint32_t size;
  if (!read_chunk_header(f, id, &size) || std::memcmp(id, "RIFF", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  char wave[4];
  if (std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  bool have_fmt = false;
  int64_t data_bytes = -1;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  while (read_chunk_header(f, id, &size)) {
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40] = {0};  // zero-init: a short fmt chunk must not
                              // leave rate/bits as uninitialized stack
      uint32_t take = size < sizeof(buf) ? size : sizeof(buf);
      if (std::fread(buf, 1, take, f) != take) break;
      if (size > take) std::fseek(f, size - take, SEEK_CUR);
      if (take < 16) break;   // malformed: fmt needs >= 16 bytes
      std::memcpy(&fmt, buf, 2);
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&rate, buf + 4, 4);
      std::memcpy(&bits, buf + 14, 2);
      if (fmt == 0xFFFE && size >= 40) std::memcpy(&fmt, buf + 24, 2);
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      data_bytes = size;
      std::fseek(f, size + (size & 1), SEEK_CUR);
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (!have_fmt || data_bytes < 0 || channels == 0 || bits < 8) return -3;
  // bits < 8 (e.g. 4-bit IMA-ADPCM) would make bits/8 == 0 below - the
  // Python decoders handle those formats; report unsupported instead of
  // dividing by zero.
  info->sample_rate = static_cast<int32_t>(rate);
  info->channels = channels;
  info->bits = bits;
  info->format = fmt;
  info->frames = data_bytes / (channels * (bits / 8));
  return 0;
}

// Read samples as float32 interleaved into out[frames*channels].
int dpdfnet_wav_read(const char* path, float* out, int64_t cap) {
  WavInfo info;
  int rc = dpdfnet_wav_info(path, &info);
  if (rc != 0) return rc;
  const int64_t total = info.frames * info.channels;
  if (total > cap) return -4;

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char id[4];
  uint32_t size;
  std::fseek(f, 12, SEEK_SET);
  while (read_chunk_header(f, id, &size)) {
    if (std::memcmp(id, "data", 4) == 0) {
      if (info.format == 3 && info.bits == 32) {
        if (std::fread(out, 4, total, f) != static_cast<size_t>(total)) {
          std::fclose(f);
          return -5;
        }
      } else if (info.format == 1 && info.bits == 16) {
        std::vector<int16_t> buf(total);
        if (std::fread(buf.data(), 2, total, f) != static_cast<size_t>(total)) {
          std::fclose(f);
          return -5;
        }
        for (int64_t i = 0; i < total; ++i)
          out[i] = static_cast<float>(buf[i]) / 32768.0f;
      } else {
        std::fclose(f);
        return -6;  // unsupported encoding (python fallback handles more)
      }
      std::fclose(f);
      return 0;
    }
    std::fseek(f, size + (size & 1), SEEK_CUR);
  }
  std::fclose(f);
  return -3;
}

// Write float32 samples as PCM16 wav. Returns 0 on success.
int dpdfnet_wav_write(const char* path, const float* x, int64_t frames,
                      int32_t channels, int32_t sample_rate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int64_t total = frames * channels;
  const uint32_t data_bytes = static_cast<uint32_t>(total * 2);
  const uint16_t block = static_cast<uint16_t>(channels * 2);
  const uint32_t byte_rate = sample_rate * block;
  uint32_t riff_size = 4 + 8 + 16 + 8 + data_bytes;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_size, 4, 1, f);
  std::fwrite("WAVEfmt ", 1, 8, f);
  uint32_t fmt_size = 16;
  uint16_t fmt = 1, ch = static_cast<uint16_t>(channels), bits = 16;
  std::fwrite(&fmt_size, 4, 1, f);
  std::fwrite(&fmt, 2, 1, f);
  std::fwrite(&ch, 2, 1, f);
  std::fwrite(&sample_rate, 4, 1, f);
  std::fwrite(&byte_rate, 4, 1, f);
  std::fwrite(&block, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> buf(total);
  for (int64_t i = 0; i < total; ++i) {
    float v = x[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    buf[i] = static_cast<int16_t>(v * 32767.0f);
  }
  std::fwrite(buf.data(), 2, total, f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
