"""Rotary position embeddings with linear / dynamic-NTK scaling (port of
``moka_tpu/ops/rope.py``).  cos/sin are computed on the fly in fp32; the
rotation runs in x's dtype on half-width tables."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float,
                     scaling: tuple[str, float] | None,
                     seq_len: int | None = None, max_seq_len: int = 2048,
                     device=None) -> torch.Tensor:
    """inv_freq (head_dim/2,) fp32, with dynamic-NTK rescaling of theta
    by the TOTAL attended length ``seq_len`` (clamped at ``max_seq_len``)."""
    if scaling is not None and scaling[0] == "dynamic" and seq_len is not None:
        factor = scaling[1]
        sl = torch.clamp(torch.as_tensor(seq_len, dtype=torch.float32,
                                         device=device),
                         min=float(max_seq_len))
        theta = theta * ((factor * sl / max_seq_len) - (factor - 1)) ** (
            head_dim / (head_dim - 2))
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (torch.as_tensor(theta, dtype=torch.float32,
                                  device=device) ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0,
                 scaling: tuple[str, float] | None = None,
                 seq_len: int | None = None,
                 max_seq_len: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape positions.shape + (head_dim,), fp32."""
    inv_freq = rope_frequencies(head_dim, theta, scaling, seq_len,
                                max_seq_len, device=positions.device)
    pos = positions.to(torch.float32)
    if scaling is not None and scaling[0] == "linear":
        pos = pos / scaling[1]
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1] for the two halves x1, x2 of the last axis (HF's helper;
    ``apply_rope`` rotates the half-planes directly)."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, L, n_heads, head_dim); cos/sin: (b, L, head_dim) fp32.

    Rotates the two half-planes in x's dtype with half-width tables:
    ``out = [x1*c - x2*s, x2*c + x1*s]``."""
    half = x.shape[-1] // 2
    c = cos[:, :, None, :half].to(x.dtype)
    s = sin[:, :, None, :half].to(x.dtype)
    x1 = x[..., :half]
    x2 = x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
