"""Flash attention forward (port of ``moka_tpu/ops/flash_attention.py``,
forward only).

``flash_fwd`` computes causal + key-padding attention with GQA and a query
offset into the key axis, returning the output and the per-row
log-sum-exp.  On a CUDA tensor it launches the hand-written kernel
``kernels/csrc/flash_fwd.cu`` (or raises); on a CPU tensor it runs
``flash_fwd_plain``, the same arithmetic in plain torch.  The backward
kernels are not ported yet (ROADMAP.md, TPU kernels 2-4), so a query that
requires grad raises.

Numerics follow the JAX kernel: q is pre-scaled by ``scale * log2(e)``
rounded in q's dtype, the softmax runs in fp32 base 2 (``exp2``), and lse
is returned in natural-log units.  Rows whose keys are all masked have an
unspecified output (the kernel and the plain version differ there);
callers read valid rows only.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

_NOT_PORTED = ("flash attention backward is not ported yet (ROADMAP.md, "
               "TPU kernels 2-4)")


def _valid(attn_mask: torch.Tensor, L: int, S: int, q_offset: int,
           causal: bool) -> torch.Tensor:
    """(b, L, S) bool: key k visible to query row i."""
    dev = attn_mask.device
    ok = (attn_mask[:, None, :] > 0).expand(-1, L, -1)
    if causal:
        q_pos = torch.arange(L, device=dev)[:, None] + q_offset
        ok = ok & (q_pos >= torch.arange(S, device=dev)[None, :])[None]
    return ok


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: torch.Tensor, q_offset: int = 0,
                    causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain torch, over the whole key axis at
    once.  q (b, L, H, hd), k/v (b, S, K, hd), attn_mask (b, S).  Returns
    (out (b, L, H, hd) in q's dtype, lse (b, H, L) fp32)."""
    b, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qs = q * torch.tensor(LOG2E / math.sqrt(hd), dtype=q.dtype)
    s = torch.einsum("blkgh,bskh->bkgls", qs.reshape(b, L, K, G, hd).float(),
                     k.float())
    ok = _valid(attn_mask, L, S, q_offset, causal)[:, None, None]
    s = torch.where(ok, s, s.new_tensor(NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
    o = torch.einsum("bkgls,bskh->bkglh", p.to(v.dtype).float(), v.float())
    o = (o / safe).permute(0, 3, 1, 2, 4).reshape(b, L, H, hd)
    lse = ((m + torch.log2(safe)) * LN2).reshape(b, H, L)
    return o.to(q.dtype), lse


_lib = None


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        lib = kernels.library("flash_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moka_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                       i, ctypes.c_float, p]
        lib.moka_flash_fwd.restype = i
        _lib = lib
    return _lib


def _launch(q, k, v, attn_mask, q_offset: int, causal: bool):
    from moka_tpu_torch import kernels
    b, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16 tensors, {name} is "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if hd != 128:
        raise ValueError(f"flash kernel supports head_dim 128, not {hd}")
    if H % K or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if tuple(attn_mask.shape) != (b, S):
        raise ValueError(f"attn_mask {tuple(attn_mask.shape)} != {(b, S)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel needs 16-byte aligned q, k, v")
    mask = attn_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, H, L), dtype=torch.float32, device=q.device)
    qscale = float(torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.bfloat16))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _library().moka_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, H, K, L, S, hd, int(q_offset),
        int(bool(causal)), qscale, stream)
    kernels.check(status, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              attn_mask: torch.Tensor, q_offset: int = 0,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of flash attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  q (b, L, H, hd), k/v (b, S, K, hd),
    attn_mask (b, S) validity, q_offset = position of query 0 on the key
    axis (an int)."""
    if torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError(_NOT_PORTED)
    if q.device.type == "cuda":
        return _launch(q, k, v, attn_mask, q_offset, causal)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, attn_mask, q_offset, causal)
    raise ValueError(f"no flash attention for device {q.device}")


flash_fwd.launches = 0  # kernel launches (CUDA tensors only)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              attn_mask: torch.Tensor, q_offset: int = 0,
              causal: bool = True) -> torch.Tensor:
    """Drop-in for ``ops.attention.mha`` with the mask given as a (b, S)
    validity vector: returns (b, L, H, hd)."""
    return flash_fwd(q, k, v, attn_mask, q_offset, causal)[0]
