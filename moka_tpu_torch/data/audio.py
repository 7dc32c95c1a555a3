"""Audio loading + segment windowing (host-side; port of
``moka_tpu/data/audio.py``).

Reference loads with ``librosa.load(path, sr=16000, mono=True)``
(``unified_dataset.py:176``); the package does not depend on librosa/ffmpeg, so WAV
goes through the stdlib/scipy and compressed formats raise with a clear
message.  ``segment_windows`` reproduces the
reference's AVQA / AVE slicing exactly, including the integer
``nums_per_second = len(audio) // total`` arithmetic and edge zero-padding
(``unified_dataset.py:174-195,219-239``)."""

from __future__ import annotations

import numpy as np


def load_audio(path: str, sr: int = 16000) -> np.ndarray:
    """-> float32 mono waveform in [-1, 1] at the requested rate."""
    if path.endswith(".wav"):
        from scipy.io import wavfile
        rate, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        if rate != sr:
            data = resample_linear(data, rate, sr)
        return data
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    raise NotImplementedError(
        f"cannot decode {path}: only .wav/.npy supported in this environment "
        "(no ffmpeg/librosa); convert mp3 offline or provide .npy waveforms")


def resample_linear(wav: np.ndarray, src_rate: int, dst_rate: int
                    ) -> np.ndarray:
    n_out = int(round(len(wav) * dst_rate / src_rate))
    x_out = np.linspace(0.0, len(wav) - 1, n_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)


def segment_windows(wav: np.ndarray, total_seconds: int, stride: int,
                    before: float, after: float) -> list[np.ndarray]:
    """Reference slicing: for t in range(0, total, stride), window
    [t-before, t+after] seconds with zero-pad at the edges.

    AVQA: total=60, stride=6, before=0.5, after=1.5 (2 s windows).
    AVE:  total=10, stride=1, before=0.0, after=1.0 (1 s windows)."""
    nps = int(len(wav) / total_seconds)  # integer samples-per-second
    width = int((before + after) * nps)
    out = []
    for t in range(0, total_seconds, stride):
        start = max(0.0, t - before)
        end = min(float(total_seconds), t + after)
        seg = wav[int(start * nps): int(nps * end)]
        if t - before < 0:
            seg = np.concatenate(
                [np.zeros(width - len(seg), np.float32), seg])
        if t + after > total_seconds:
            seg = np.concatenate(
                [seg, np.zeros(width - len(seg), np.float32)])
        out.append(seg.astype(np.float32))
    return out
