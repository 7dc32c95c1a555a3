"""Fused lm_head + cross-entropy on an int8 head (port of
``moka_tpu/ops/fused_ce.py``): the (rows, V) logits never reach device
memory.

``fused_ce_loss(h, lm_head, targets)`` is the mean CE over the valid
targets of ``logits = (bf16(h) @ bf16(w_i8)) * scale``.  On a CUDA tensor
``fused_ce_fwd`` and ``fused_ce_bwd`` launch the kernels of
``kernels/csrc/fused_ce.cu`` (TPU kernel 8) and ``fused_ce_bwd.cu`` (TPU
kernel 9) or raise; on a CPU tensor they run ``fused_ce_fwd_plain`` /
``fused_ce_bwd_plain``, the same arithmetic in plain torch.  Both check
what they are given the same way.

Numerics, as the JAX kernels: h is cast to bf16 first; products of bf16 h
and the int8 codes (exact in fp32) summed in fp32, then scaled per column;
lse = m + log(l) in natural-log units, nll = lse - target logit (the target
picked by comparison: an ignored target matches no column, so its nll is
lse).  Backward (the head is frozen: dx only): p = exp(logit - lse), minus
1 at the target, times the row's cotangent and the column's scale, rounded
to bf16, times the bf16 codes transposed, fp32 sums, dx in x's dtype.
Ignored rows get cotangent 0 from the mean and add nothing.

Padding: the kernels take the vocab padded with zero columns to a multiple
of ``VOCAB_TILE`` (phantom columns masked to -1e30, as ``_vocab_pad``);
the padded head is built once per head tensor and kept while it lives
(``quant.operand_cache``), where JAX pads on every call.  Rows are not
padded: the kernels mask the ragged last row block, where JAX pads rows
with ignored targets.
"""

from __future__ import annotations

import ctypes

import torch

from moka_tpu_torch.core.device import on_card
from moka_tpu_torch.ops.quant import operand_cache

NEG_INF = -1e30
VOCAB_TILE = 512   # vocab columns a CTA covers (fused_ce.cu and
                   # fused_ce_bwd.cu: SPAN)
K_TILE = 64        # the kernels' contraction step: d % 64 == 0


def _logits(x, w_q, w_scale):
    """fp32 (N, V) logits: bf16 x times the int8 codes (exact products)
    summed in fp32, then the column scale."""
    return (x.float() @ w_q.float()) * w_scale.reshape(1, -1).float()


def _target_hits(targets, v):
    """(N, V) bool: the target's column (none for an ignored target)."""
    cols = torch.arange(v, device=targets.device)
    return cols[None, :] == targets.long()[:, None]


def fused_ce_fwd_plain(x, w_q, w_scale, targets):
    """(nll, lse), each (N,) fp32."""
    logits = _logits(x, w_q, w_scale)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.where(_target_hits(targets, logits.shape[1]), logits,
                      logits.new_zeros(())).sum(dim=-1)
    return lse - tgt, lse


def fused_ce_bwd_plain(x, w_q, w_scale, targets, lse, g):
    """dx (N, d) in x's dtype for the per-row cotangent g (N,)."""
    logits = _logits(x, w_q, w_scale)
    p = torch.exp(logits - lse[:, None])
    p = torch.where(_target_hits(targets, p.shape[1]), p - 1.0, p)
    p = p * g.float()[:, None] * w_scale.reshape(1, -1).float()
    dx = p.to(torch.bfloat16).float() @ w_q.float().t()
    return dx.to(x.dtype)


def _check(x, w_q, w_scale, targets, *rows):
    """What both the kernels and the plain versions take: x (N, d) bf16,
    w_q (d, V) int8, scale V fp32, targets (N,) integers, per-row fp32
    tensors (N,), all on one device."""
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and head {tuple(w_q.shape)}: "
                         f"want (N, d) and (d, V)")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8:
        raise TypeError(f"fused CE takes bf16 x and an int8 head, not "
                        f"{x.dtype} and {w_q.dtype}")
    if w_scale.numel() != w_q.shape[1] or w_scale.dtype != torch.float32:
        raise ValueError(f"scale {tuple(w_scale.shape)} {w_scale.dtype} for "
                         f"V {w_q.shape[1]}: want V fp32 values")
    n = x.shape[0]
    if tuple(targets.shape) != (n,) or targets.is_floating_point():
        raise ValueError(f"targets {tuple(targets.shape)} {targets.dtype}: "
                         f"want ({n},) integers")
    for t in rows:
        if tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"per-row input {tuple(t.shape)} {t.dtype}: "
                             f"want ({n},) fp32")
    if any(t.device != x.device for t in (w_q, w_scale, targets, *rows)):
        raise ValueError("fused CE inputs lie on more than one device")


# ----------------------------------------------------------- CUDA kernels

_libs: dict[str, ctypes.CDLL] = {}  # by library: fused_ce, fused_ce_bwd


def bind(name: str, lib):
    """``lib`` (library ``name``'s build, or an edited copy of its source)
    with the argument types of its entry point set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.moka_fused_ce_fwd if name == "fused_ce" else \
        lib.moka_fused_ce_bwd
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    return lib


def _library(name: str):
    """Library ``fused_ce`` (kernel 8, ``moka_fused_ce_fwd``) or
    ``fused_ce_bwd`` (kernel 9, ``moka_fused_ce_bwd``), built and bound on
    first use."""
    lib = _libs.get(name)
    if lib is None:
        from moka_tpu_torch import kernels
        lib = _libs[name] = bind(name, kernels.library(name))
    return lib


def padded_head(w_q, w_scale):
    """(w (d, Vp) int8, scale (Vp,) fp32) with Vp the vocab rounded up to
    ``VOCAB_TILE`` (zero columns), built once per head tensor."""
    cache = operand_cache(w_q)
    if "fused_ce" not in cache:
        d, v = w_q.shape
        vp = -(-v // VOCAB_TILE) * VOCAB_TILE
        w = torch.zeros((d, vp), dtype=torch.int8, device=w_q.device)
        w[:, :v] = w_q
        s = torch.zeros((vp,), dtype=torch.float32, device=w_q.device)
        s[:v] = w_scale.reshape(-1)
        cache["fused_ce"] = (w, s)
    return cache["fused_ce"]


def _kernel_inputs(x, w_q, w_scale, targets):
    if x.shape[1] % K_TILE:
        raise ValueError(f"fused CE kernels need d % {K_TILE} == 0, got "
                         f"{x.shape[1]}")
    if x.shape[0] == 0:
        raise ValueError("fused CE kernels need at least one row")
    w, s = padded_head(w_q, w_scale)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels' tensor maps
        x = x.clone()
    return x, w, s, targets.to(torch.int32).contiguous(), w_q.shape[1]


def _launch_fwd(x, w_q, w_scale, targets):
    from moka_tpu_torch import kernels
    x, w, s, t, v = _kernel_inputs(x, w_q, w_scale, targets)
    n, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((3, w.shape[1] // VOCAB_TILE, n), **f32)
    nll, lse = torch.empty((n,), **f32), torch.empty((n,), **f32)
    status = _library("fused_ce").moka_fused_ce_fwd(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
        part.data_ptr(), nll.data_ptr(), lse.data_ptr(), n, d, w.shape[1],
        v, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(status, "fused_ce_fwd")
    fused_ce_fwd.launches += 1
    return nll, lse


def _bwd_into(work, x, w, s, t, lse, g, v):
    """Kernel 9 alone: adds dx to the fp32 workspace ``work`` (N, d), on
    inputs as ``_kernel_inputs`` returns them."""
    from moka_tpu_torch import kernels
    n, d = x.shape
    status = _library("fused_ce_bwd").moka_fused_ce_bwd(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
        lse.data_ptr(), g.data_ptr(), work.data_ptr(), n, d, w.shape[1], v,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(status, "fused_ce_bwd")


def _launch_bwd(x, w_q, w_scale, targets, lse, g):
    x, w, s, t, v = _kernel_inputs(x, w_q, w_scale, targets)
    work = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    _bwd_into(work, x, w, s, t, lse.contiguous(), g.contiguous(), v)
    fused_ce_bwd.launches += 1
    return work.to(x.dtype)


def fused_ce_fwd(x, w_q, w_scale, targets):
    """Kernel 8: (nll, lse) (N,) fp32 of x (N, d) bf16 against the int8
    head (d, V) with its V column scales; targets (N,) (an ignored one
    matches no column)."""
    _check(x, w_q, w_scale, targets)
    if on_card(x, "fused CE"):
        return _launch_fwd(x, w_q, w_scale, targets)
    return fused_ce_fwd_plain(x, w_q, w_scale, targets)


def fused_ce_bwd(x, w_q, w_scale, targets, lse, g):
    """Kernel 9: dx (N, d) bf16 from the forward's lse and the per-row
    cotangent g (N,) fp32; the logits are recomputed, never stored."""
    _check(x, w_q, w_scale, targets, lse, g)
    if on_card(x, "fused CE"):
        return _launch_bwd(x, w_q, w_scale, targets, lse, g)
    return fused_ce_bwd_plain(x, w_q, w_scale, targets, lse, g)


# kernel launches (CUDA tensors only)
fused_ce_fwd.launches = 0
fused_ce_bwd.launches = 0


class _NllRows(torch.autograd.Function):
    """Per-row nll, differentiable in x only (the head is frozen): saves x,
    the targets and lse; the head stays on ctx."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, targets, plain):
        fwd = fused_ce_fwd_plain if plain else fused_ce_fwd
        nll, lse = fwd(x, w_q, w_scale, targets)
        ctx.head, ctx.plain = (w_q, w_scale), plain
        ctx.save_for_backward(x, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, targets, lse = ctx.saved_tensors
        bwd = fused_ce_bwd_plain if ctx.plain else fused_ce_bwd
        dx = bwd(x, *ctx.head, targets, lse, g.float().contiguous())
        return dx, None, None, None, None


def _loss(h, lm_head, targets, ignore_index, plain):
    x = h.to(torch.bfloat16)
    w_scale = lm_head["scale"].reshape(-1).float()
    nll = _NllRows.apply(x, lm_head["w_i8"], w_scale, targets, plain)
    valid = targets != ignore_index
    count = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, nll.new_zeros(())).sum() / count


def fused_ce_loss(h, lm_head, targets, *, ignore_index: int = -100):
    """Mean CE over the targets that are not ``ignore_index``: h (rows, d),
    lm_head an int8 ``{"w_i8", "scale"}`` dict
    (``quantize_llama_base(head_bits=8)``), targets (rows,) integers.
    Differentiable in h only; kernels 8-9 on CUDA tensors."""
    return _loss(h, lm_head, targets, ignore_index, plain=False)


def fused_ce_loss_plain(h, lm_head, targets, *, ignore_index: int = -100):
    """``fused_ce_loss`` through the plain versions on any device."""
    return _loss(h, lm_head, targets, ignore_index, plain=True)
