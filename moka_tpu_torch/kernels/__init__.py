"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
Libraries go to ``build/moka_tpu_torch/`` at the root of the checkout and
are named by a hash of the source, the headers under ``csrc/`` and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  Nothing is built or loaded at import:
the first wrapper that launches a kernel calls ``library(name)``.  A failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moka_tpu_torch"
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "flash_bwd_kv": "flash_bwd_kv.cu",
    "moka_delta_fwd": "moka_delta_fwd.cu",
    "fused_dropout": "fused_dropout.cu",
    "fused_ce": "fused_ce.cu",
    "fused_ce_bwd": "fused_ce_bwd.cu",
    "block_diag": "block_diag.cu",
    "flash_rank": "flash_rank.cu",
    "paged_decode": "paged_decode.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str, csrc: Path = CSRC) -> Path:
    """The library path of kernel ``name``: keyed by its source, every
    header under ``csrc`` (a source may include any of them) and the
    flags."""
    h = hashlib.sha256((csrc / SOURCES[name]).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's report (``nvcc -Xptxas -v``) for the library
    ``_target(name)``, beside it and keyed alike."""
    return _target(name).with_suffix(".log")


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns seconds per
    compiled source; the compiler's resource report goes to
    ``log_path(name)``.  Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(log_path(name), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, out,
                       log)
    seconds, failed = {}, []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = "\n".join(log_path(n).read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error "
                           f"{status}")
