// Native Kaldi-compatible fbank — the dataloader hot path.
//
// The port's copy of moka_tpu/native/fbank.cpp.  The reference computes
// fbank per __getitem__ via torchaudio's C++ kernels
// (dataset/audio_processor.py:29-41); this is the equivalent native
// component for the host input pipeline: radix-2 real FFT + mel banks,
// no dependencies, OpenMP-free (the loader parallelizes across samples).
//
// Exposed C ABI (ctypes):
//   moka_fbank(wave, n_samples, sample_rate, num_mel_bins,
//              frame_len_ms, frame_shift_ms, preemph, out)
// out must hold num_frames(n_samples) * num_mel_bins floats;
// moka_fbank_num_frames gives the frame count.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kMelLowHz = 20.0;

double mel(double hz) { return 1127.0 * std::log(1.0 + hz / 700.0); }

// iterative in-place radix-2 complex FFT
void fft(std::vector<double>& re, std::vector<double>& im) {
  const size_t n = re.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) { std::swap(re[i], re[j]); std::swap(im[i], im[j]); }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * M_PI / static_cast<double>(len);
    const double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        const size_t a = i + k, b = i + k + len / 2;
        const double ur = re[a], ui = im[a];
        const double vr = re[b] * cr - im[b] * ci;
        const double vi = re[b] * ci + im[b] * cr;
        re[a] = ur + vr; im[a] = ui + vi;
        re[b] = ur - vr; im[b] = ui - vi;
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

struct MelBank {
  int first_bin;
  std::vector<double> weights;
};

std::vector<MelBank> make_banks(int num_bins, int fft_size,
                                double sample_rate) {
  const int n_fft_bins = fft_size / 2;
  const double high_freq = sample_rate / 2.0;
  const double bin_width = sample_rate / fft_size;
  const double mel_low = mel(kMelLowHz), mel_high = mel(high_freq);
  const double mel_delta = (mel_high - mel_low) / (num_bins + 1);
  std::vector<MelBank> banks(num_bins);
  for (int b = 0; b < num_bins; ++b) {
    const double left = mel_low + b * mel_delta;
    const double center = left + mel_delta;
    const double right = center + mel_delta;
    MelBank bank;
    bank.first_bin = -1;
    for (int i = 0; i < n_fft_bins; ++i) {
      const double m = mel(bin_width * i);
      const double up = (m - left) / (center - left);
      const double down = (right - m) / (right - center);
      const double w = std::fmin(up, down);
      if (w > 0.0) {
        if (bank.first_bin < 0) bank.first_bin = i;
        bank.weights.push_back(w);
      } else if (bank.first_bin >= 0) {
        break;
      }
    }
    if (bank.first_bin < 0) bank.first_bin = 0;
    banks[b] = std::move(bank);
  }
  return banks;
}

}  // namespace

extern "C" {

int64_t moka_fbank_num_frames(int64_t n_samples, double sample_rate,
                              double frame_len_ms, double frame_shift_ms) {
  const int64_t win = static_cast<int64_t>(sample_rate * frame_len_ms / 1000.0);
  const int64_t shift =
      static_cast<int64_t>(sample_rate * frame_shift_ms / 1000.0);
  if (n_samples < win) return 0;
  return 1 + (n_samples - win) / shift;
}

// Returns number of frames written (or -1 on error).
int64_t moka_fbank(const float* wave, int64_t n_samples, double sample_rate,
                   int num_mel_bins, double frame_len_ms,
                   double frame_shift_ms, double preemph, float* out) {
  const int win = static_cast<int>(sample_rate * frame_len_ms / 1000.0);
  const int shift = static_cast<int>(sample_rate * frame_shift_ms / 1000.0);
  const int64_t num_frames =
      moka_fbank_num_frames(n_samples, sample_rate, frame_len_ms,
                            frame_shift_ms);
  if (num_frames <= 0) return num_frames;

  int fft_size = 1;
  while (fft_size < win) fft_size <<= 1;
  const int n_fft_bins = fft_size / 2;

  // povey window
  std::vector<double> window(win);
  for (int i = 0; i < win; ++i) {
    const double hann =
        0.5 - 0.5 * std::cos(2.0 * M_PI * i / static_cast<double>(win - 1));
    window[i] = std::pow(hann, 0.85);
  }
  static thread_local std::vector<MelBank> banks;
  static thread_local int banks_bins = -1, banks_fft = -1;
  static thread_local double banks_rate = -1;
  if (banks_bins != num_mel_bins || banks_fft != fft_size ||
      banks_rate != sample_rate) {
    banks = make_banks(num_mel_bins, fft_size, sample_rate);
    banks_bins = num_mel_bins; banks_fft = fft_size; banks_rate = sample_rate;
  }

  std::vector<double> frame(win), re(fft_size), im(fft_size),
      power(n_fft_bins);
  const double eps = 2.220446049250313e-16;  // DBL_EPSILON

  for (int64_t f = 0; f < num_frames; ++f) {
    const float* src = wave + f * shift;
    double mean = 0.0;
    for (int i = 0; i < win; ++i) mean += src[i];
    mean /= win;
    for (int i = 0; i < win; ++i) frame[i] = src[i] - mean;
    // preemphasis with reflected first sample
    for (int i = win - 1; i > 0; --i)
      frame[i] -= preemph * frame[i - 1];
    frame[0] -= preemph * frame[0];
    for (int i = 0; i < win; ++i) frame[i] *= window[i];

    std::fill(re.begin(), re.end(), 0.0);
    std::fill(im.begin(), im.end(), 0.0);
    std::copy(frame.begin(), frame.end(), re.begin());
    fft(re, im);
    for (int i = 0; i < n_fft_bins; ++i)
      power[i] = re[i] * re[i] + im[i] * im[i];

    float* dst = out + f * num_mel_bins;
    for (int b = 0; b < num_mel_bins; ++b) {
      const MelBank& bank = banks[b];
      double acc = 0.0;
      for (size_t i = 0; i < bank.weights.size(); ++i)
        acc += bank.weights[i] * power[bank.first_bin + i];
      dst[b] = static_cast<float>(std::log(acc > eps ? acc : eps));
    }
  }
  return num_frames;
}

}  // extern "C"
