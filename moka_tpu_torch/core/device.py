"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a missing
``device`` means ``"cuda"``, and asking for CUDA where there is none raises
instead of silently falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def on_card(t: torch.Tensor, what: str) -> bool:
    """Whether a kernel wrapper launches its CUDA kernel for ``t`` (True) or
    runs its plain version (False, a CPU tensor); any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} for device {t.device}")
    return t.device.type == "cuda"


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw pointer: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a ``Stream`` object (a wrapper's launch needs only the
    pointer)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
