"""Multi-head attention with GQA, fp32 softmax and an additive bias (port of
``moka_tpu/ops/attention.py``).  The eager path: prefill takes the flash
kernel on the card, the single-token decode steps take this."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def causal_bias(attn_mask: torch.Tensor, q_len: int, kv_len: int,
                q_offset: int = 0) -> torch.Tensor:
    """Additive (b, 1, q_len, kv_len) fp32 bias: causal + key padding.

    attn_mask: (b, kv_len) 0/1; q_offset: position of query 0 on the key
    axis (decode steps pass the cache length)."""
    dev = attn_mask.device
    q_pos = torch.arange(q_len, device=dev)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=dev)[None, :]
    ok = (q_pos >= k_pos)[None] & (attn_mask[:, None, :] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(ok, zero, zero + NEG_INF)[:, None]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    """q: (b, L, H, hd); k/v: (b, S, K, hd) with H = K * G; bias (b,1,L,S).
    Returns (b, L, H, hd) in q's dtype; scores and softmax in fp32."""
    b, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(b, L, K, G, hd)
    scores = torch.einsum("blkgh,bskh->bkgls", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd)) + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgls,bskh->blkgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, L, H, hd).to(q.dtype)
