"""Kaldi-compatible log-mel fbank frontend (host-side, numpy; port of
``moka_tpu/data/fbank.py``).

Reference: ``AudioVisualText/dataset/audio_processor.py:29-41`` — the audio
pipeline is ``ta_kaldi.fbank(waveform * 2**15, num_mel_bins=128,
sample_frequency=16000, frame_length=25, frame_shift=10)`` followed by
normalization ``(x - 15.41663) / (2 * 6.55582)`` (BEATs AS2M stats).
torchaudio's implementation follows Kaldi's ``compute-fbank-feats`` with
these defaults, which are reproduced here:

  dither=0, remove_dc_offset=True, preemphasis 0.97 (reflected first
  sample), povey window ((0.5-0.5cos)^0.85), snip_edges=True, FFT padded to
  the next power of two, POWER spectrum, Kaldi mel scale 1127*ln(1+f/700)
  with low=20 Hz / high=Nyquist, log with eps floor.

1 s @ 16 kHz -> 98 frames x 128 mels (SURVEY.md §2.10 audio frontend row).
A C++ twin lives in ``moka_tpu_torch/native`` for the dataloader hot path;
the two implementations cross-validate each other in tests.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

MEL_LOW_HZ = 20.0
FBANK_MEAN = 15.41663
FBANK_STD = 6.55582


def _mel(hz):
    return 1127.0 * np.log(1.0 + hz / 700.0)


def povey_window(n: int) -> np.ndarray:
    hann = 0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / (n - 1))
    return hann ** 0.85


def mel_banks(num_bins: int, fft_size: int, sample_rate: float,
              low_freq: float = MEL_LOW_HZ,
              high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel filter bank: (num_bins, fft_size // 2 + 1)... Kaldi actually
    drops the Nyquist bin and uses fft_size/2 points."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2 + high_freq
    n_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    freqs = _mel(fft_bin_width * np.arange(n_fft_bins))  # (n_fft_bins,)
    banks = np.zeros((num_bins, n_fft_bins), np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (freqs - left) / (center - left)
        down = (right - freqs) / (right - center)
        banks[b] = np.clip(np.minimum(up, down), 0.0, None)
    return banks


def fbank(waveform: np.ndarray, sample_rate: int = 16000,
          num_mel_bins: int = 128, frame_length_ms: float = 25.0,
          frame_shift_ms: float = 10.0,
          preemphasis: float = 0.97) -> np.ndarray:
    """(num_samples,) float waveform (Kaldi int16 scale, i.e. x * 2**15)
    -> (num_frames, num_mel_bins) log-mel features."""
    wav = np.asarray(waveform, np.float64)
    win = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    if len(wav) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    num_frames = 1 + (len(wav) - win) // shift
    idx = np.arange(win)[None, :] + shift * np.arange(num_frames)[:, None]
    frames = wav[idx]  # (num_frames, win)

    # remove per-frame DC offset
    frames = frames - frames.mean(axis=1, keepdims=True)
    # preemphasis with reflected first sample
    prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - preemphasis * prev
    frames = frames * povey_window(win)

    fft_size = 1 << (win - 1).bit_length()  # next power of two (512)
    spec = np.fft.rfft(frames, n=fft_size, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : fft_size // 2]

    banks = mel_banks(num_mel_bins, fft_size, sample_rate)
    mel = power @ banks.T
    eps = sys.float_info.epsilon
    return np.log(np.maximum(mel, eps)).astype(np.float32)


def beats_fbank(waveform: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
    """Waveform in [-1, 1] -> normalized (T, 128) fbank exactly as the
    reference preprocess does (``audio_processor.py:29-41``,
    ``BEATs.py:119-132``).

    Rides the C++ frontend (``moka_tpu_torch/native``, built at first use;
    a failed build raises) — the fbank is the dataloader's audio hot loop
    (10 segments/sample).  ``MOKA_FBANK=numpy`` takes the float64 numpy
    path instead, which bit-mirrors the reference preprocessing
    (``audio_processor.py`` is float64 end to end): the escape hatch for
    parity-sensitive evals."""
    wav = np.asarray(waveform, np.float64) * (2 ** 15)
    if os.environ.get("MOKA_FBANK", "native") == "numpy":
        feats = fbank(wav, sample_rate=sample_rate)
    else:
        from moka_tpu_torch.native import native_fbank
        feats = native_fbank(wav.astype(np.float32), sample_rate=sample_rate)
    return (feats - FBANK_MEAN) / (2 * FBANK_STD)
