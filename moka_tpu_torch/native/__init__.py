"""Native (C++) host components, loaded through ctypes (port of
``moka_tpu/native/``).

``fbank.cpp`` is the dataloader's log-mel frontend.  It is compiled by
``g++`` at first use into ``build/moka_tpu_torch/`` at the root of the
checkout, as a library named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  Importing this
module builds and loads nothing.  A failed build raises; the numpy twin
(``data/fbank.py::fbank``) is reached only through ``MOKA_FBANK=numpy``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fbank.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moka_tpu_torch"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def target(source: Path = SOURCE) -> Path:
    """The library path of ``source``: keyed by its content and the
    flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmoka_native-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library exists; returns the library's
    path.  Raises if ``g++`` fails."""
    out = target(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: another process sees it whole
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded fbank library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.moka_fbank.restype = ctypes.c_int64
            lib.moka_fbank.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_double, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_float)]
            lib.moka_fbank_num_frames.restype = ctypes.c_int64
            lib.moka_fbank_num_frames.argtypes = [
                ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                ctypes.c_double]
            _lib = lib
        return _lib


def native_fbank(waveform: np.ndarray, sample_rate: int = 16000,
                 num_mel_bins: int = 128, frame_length_ms: float = 25.0,
                 frame_shift_ms: float = 10.0,
                 preemphasis: float = 0.97) -> np.ndarray:
    """The C++ fbank: (num_samples,) float waveform -> (num_frames,
    num_mel_bins) float32 log-mel features."""
    lib = get_lib()
    wav = np.ascontiguousarray(waveform, np.float32)
    n = lib.moka_fbank_num_frames(len(wav), float(sample_rate),
                                  frame_length_ms, frame_shift_ms)
    out = np.empty((max(n, 0), num_mel_bins), np.float32)
    if n <= 0:
        return out
    wrote = lib.moka_fbank(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav),
        float(sample_rate), num_mel_bins, frame_length_ms, frame_shift_ms,
        preemphasis, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if wrote != n:
        raise RuntimeError(f"moka_fbank wrote {wrote} frames, expected {n}")
    return out
