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
