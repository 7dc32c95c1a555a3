"""Flash attention, forward and backward (port of
``moka_tpu/ops/flash_attention.py``).

``flash_fwd`` computes causal + key-padding attention with GQA and a query
offset into the key axis, returning the output and the per-row
log-sum-exp.  The three backward functions take the forward's lse and
``delta = rowsum(dO * O)`` and return the gradients: ``flash_bwd_fused``
(dq, dk, dv in one kernel, for short sequences), ``flash_bwd_dq`` and
``flash_bwd_dkv`` (the blocked pair; ring attention calls them per key
shard with the global lse and delta).  On a CUDA tensor each launches its
hand-written kernel (wgmma and TMA: ``kernels/csrc/flash_fwd.cu`` and
the dq kernel ``flash_bwd.cu``, query-major; ``flash_bwd_kv.cu`` for the
fused and dk/dv backward, key-major) or raises; on a CPU tensor it runs
``flash_fwd_plain`` / ``flash_bwd_plain``, the same arithmetic in plain
torch.  ``flash_mha`` is the differentiable
entry point (a ``torch.autograd.Function``) and dispatches the backward
as the JAX custom VJP does (``use_fused_bwd``).

The rank route: fp32 tensors with one head (H = KH = 1) and head_dim <=
16, MokA's rank-space cross-attention (``ops.moka``, ``flash_rank_attn``),
run on their own kernels (``kernels/csrc/flash_rank.cu``: a forward, a dq
and a dk/dv kernel, fp32 SIMT, built for head_dim 4, 8 and 16) through the
wrappers ``flash_rank_fwd``, ``flash_rank_bwd_dq`` and
``flash_rank_bwd_dkv``, with the same contract and the same plain
versions.  Its backward is always the dq + dk/dv pair.  bf16 at head_dim
128 keeps the kernels above, and the forward also takes head_dim 64 (the
frozen CLIP tower, non-causal); anything else on the card raises.

Numerics follow the JAX kernels: q is pre-scaled by ``scale * log2(e)``
rounded in q's dtype, the softmax runs in fp32 base 2 (``exp2``), and lse
is in natural-log units.  Rows whose keys are all masked have zero
gradients and, on the bf16 route, an unspecified forward output (the
kernel writes 0 and lse -1e30 ln 2, the plain version the mean of V;
callers read valid rows only).
On the rank route such a row's output is the mean of V over all S keys,
as the plain version's (the forward kernel walks only the visible span
of keys and takes that branch for a row that sees none): zero for
MokA's no-question samples, whose keys are all zero.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from moka_tpu_torch.core.device import on_card, raw_stream

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _valid(attn_mask: torch.Tensor, L: int, S: int, q_offset: int,
           causal: bool) -> torch.Tensor:
    """(b, L, S) bool: key k visible to query row i."""
    dev = attn_mask.device
    ok = (attn_mask[:, None, :] > 0).expand(-1, L, -1)
    if causal:
        q_pos = torch.arange(L, device=dev)[:, None] + q_offset
        ok = ok & (q_pos >= torch.arange(S, device=dev)[None, :])[None]
    return ok


def _prescaled(q: torch.Tensor) -> torch.Tensor:
    """q * (scale * log2 e), the scalar and the product rounded in q's
    dtype, as the JAX wrappers fold it."""
    return q * torch.tensor(LOG2E / math.sqrt(q.shape[-1]), dtype=q.dtype)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: torch.Tensor, q_offset: int = 0,
                    causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain torch, over the whole key axis at
    once.  q (b, L, H, hd), k/v (b, S, K, hd), attn_mask (b, S).  Returns
    (out (b, L, H, hd) in q's dtype, lse (b, H, L) fp32)."""
    b, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qs = _prescaled(q)
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


def flash_bwd_plain(q, k, v, attn_mask, dout, lse, delta, q_offset: int = 0,
                    causal: bool = True):
    """The backward kernels' arithmetic in plain torch, over the whole key
    axis at once.  q/dout (b, L, H, hd), k/v (b, S, K, hd), lse/delta
    (b, H, L) fp32.  Returns dq (b, L, H, hd) in q's dtype and dk, dv
    (b, S, K, hd) fp32, summed over each GQA group.

    p = exp2(s - lse * log2 e), zero on rows whose lse marks them fully
    masked; p is rounded to dout's dtype before p^T dO, ds = p (dp - delta)
    to q's dtype before ds K and ds^T q; dq carries the softmax scale and
    dk the ln 2 that undoes the log2 e folded into q."""
    b, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qs = _prescaled(q).reshape(b, L, K, G, hd).float()
    s = torch.einsum("blkgh,bskh->bkgls", qs, k.float())
    ok = _valid(attn_mask, L, S, q_offset, causal)[:, None, None]
    s = torch.where(ok, s, s.new_tensor(NEG_INF))
    lse_row = (lse.float() * LOG2E).reshape(b, K, G, L, 1)
    p = torch.where(lse_row > NEG_INF * 0.5, torch.exp2(s - lse_row),
                    s.new_zeros(()))
    do = dout.reshape(b, L, K, G, hd)
    dp = torch.einsum("blkgh,bskh->bkgls", do.float(), v.float())
    ds = p * (dp - delta.float().reshape(b, K, G, L, 1))
    dsb = ds.to(q.dtype).float()
    dq = torch.einsum("bkgls,bskh->blkgh", dsb, k.float()) * \
        (1.0 / math.sqrt(hd))
    dv = torch.einsum("bkgls,blkgh->bskh", p.to(dout.dtype).float(),
                      do.float())
    dk = torch.einsum("bkgls,blkgh->bskh", dsb, qs) * LN2
    return dq.reshape(b, L, H, hd).to(q.dtype), dk, dv


def flash_bwd_dq_plain(q, k, v, attn_mask, dout, lse, delta,
                       q_offset: int = 0, causal: bool = True):
    """dq alone of ``flash_bwd_plain``."""
    return flash_bwd_plain(q, k, v, attn_mask, dout, lse, delta, q_offset,
                           causal)[0]


def flash_bwd_dkv_plain(q, k, v, attn_mask, dout, lse, delta,
                        q_offset: int = 0, causal: bool = True):
    """(dk, dv) alone of ``flash_bwd_plain``."""
    return flash_bwd_plain(q, k, v, attn_mask, dout, lse, delta, q_offset,
                           causal)[1:]


def use_fused_bwd(L: int, S: int) -> bool:
    """The JAX dispatch (``flash_mha``'s block clamping with its default
    blocks, forward 512 and backward 1024, then ``_flash_vjp_bwd``): the
    fused whole-sequence backward when L and S, each padded to its forward
    block (clamped to the length), fit one backward block; the dq + dkv
    pair otherwise."""
    def fits(n: int) -> bool:
        blk = min(512, n)
        padded = -(-n // blk) * blk
        bwd = min(1024, padded)
        if padded % bwd:
            bwd = blk
        return bwd >= padded
    return fits(L) and fits(S)


# ----------------------------------------------------------- CUDA kernels

_libs: dict[str, ctypes.CDLL] = {}


def bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of library ``name``'s entry
    points on ``lib`` (the built library, or an edited copy of its source
    built elsewhere) and return it."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * 8  # B, H, KH, L, S, hd, q_offset, causal
    if name == "flash_fwd":
        lib.moka_flash_fwd.argtypes = [p] * 6 + dims + [f, p]
        lib.moka_flash_fwd.restype = i
    elif name == "flash_rank":
        rank_dims = [i] * 6  # B, L, S, hd, q_offset, causal
        lib.moka_flash_rank_fwd.argtypes = [p] * 6 + rank_dims + [f, p]
        lib.moka_flash_rank_bwd_dq.argtypes = [p] * 8 + rank_dims + \
            [f, f, p]
        lib.moka_flash_rank_bwd_dkv.argtypes = [p] * 9 + rank_dims + [f, p]
        for fn in ("fwd", "bwd_dq", "bwd_dkv"):
            getattr(lib, f"moka_flash_rank_{fn}").restype = i
    else:  # flash_bwd: dq; flash_bwd_kv: fused and dkv
        outs = {"flash_bwd": (("moka_flash_bwd_dq", 1),),
                "flash_bwd_kv": (("moka_flash_bwd_fused", 3),
                                 ("moka_flash_bwd_dkv", 2))}[name]
        for fn, n_out in outs:
            getattr(lib, fn).argtypes = [p] * (7 + n_out) + dims + [f, f, p]
            getattr(lib, fn).restype = i
    return lib


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        from moka_tpu_torch import kernels
        lib = _libs[name] = bind(name, kernels.library(name))
    return lib


FWD_HEAD_DIMS = (64, 128)  # flash_fwd.cu: CLIP ViT-L/14 and LLaMA-2
BWD_HEAD_DIMS = (128,)     # flash_bwd{,_kv}.cu: LLaMA-2 (the towers are
                           # frozen)


def _kernel_inputs(q, k, v, attn_mask, dout=None, lse=None, delta=None,
                   head_dims=BWD_HEAD_DIMS):
    """Check what the kernels take (bf16, a head_dim of ``head_dims``,
    contiguous, 16-byte aligned, one device) and return the tensors as they
    pass."""
    b, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    named = [("q", q), ("k", k), ("v", v)]
    if dout is not None:
        named.append(("dout", dout))
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16 tensors, {name} is "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if hd not in head_dims:
        raise ValueError(f"flash kernel supports head_dim {head_dims}, not "
                         f"{hd}")
    if H % K or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if tuple(attn_mask.shape) != (b, S):
        raise ValueError(f"attn_mask {tuple(attn_mask.shape)} != {(b, S)}")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    out = [t.contiguous() for _, t in named]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError("flash kernel needs 16-byte aligned q, k, v, dout")
    out.insert(3, attn_mask.to(device=q.device, dtype=torch.int32)
               .contiguous())
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if tuple(t.shape) != (b, H, L) or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}, want "
                             f"{(b, H, L)} on {q.device}")
        out.append(t.to(torch.float32).contiguous())
    return out


def _dims(q, k, q_offset, causal):
    b, L, H, hd = q.shape
    return (b, H, k.shape[2], L, k.shape[1], hd, int(q_offset),
            int(bool(causal)))


@functools.lru_cache(maxsize=None)
def _scales(hd: int) -> tuple[float, float]:
    """(bf16-rounded scale * log2 e, as the kernels pre-scale q; scale)."""
    return (float(torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.bfloat16)),
            1.0 / math.sqrt(hd))


def _group_sum(t: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(b, S, H, hd) per-head fp32 -> (b, S, KH, hd), summed over each
    GQA group (head h belongs to kv head h // (H // KH))."""
    b, S, H, hd = t.shape
    if H == kv_heads:
        return t
    return t.reshape(b, S, kv_heads, H // kv_heads, hd).sum(dim=3)


def _launch_fwd(q, k, v, attn_mask, q_offset: int, causal: bool):
    from moka_tpu_torch import kernels
    q, k, v, mask = _kernel_inputs(q, k, v, attn_mask,
                                   head_dims=FWD_HEAD_DIMS)
    b, L, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, H, L), dtype=torch.float32, device=q.device)
    status = _library("flash_fwd").moka_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *_dims(q, k, q_offset, causal),
        _scales(hd)[0], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(status, "flash_fwd")
    flash_fwd.launches += 1
    by_hd = flash_fwd.launches_by_head_dim
    by_hd[hd] = by_hd.get(hd, 0) + 1
    return out, lse


def _launch_bwd(which: str, q, k, v, attn_mask, dout, lse, delta,
                q_offset: int, causal: bool):
    """One backward kernel; returns its outputs as the kernel leaves them:
    dq fp32 (fused) or bf16 (dq), dk/dv fp32 per head (b, S, H, hd).  All
    three load q by TMA, which cannot scale in flight: the key-major
    kernels (fused, dkv: ``flash_bwd_kv.cu``), which load each query tile
    once per key tile, take ``_prescaled(q)``; the query-major dq kernel
    (``flash_bwd.cu``), which loads each query tile once, takes q as it is
    and scales it in shared memory, as the forward does."""
    from moka_tpu_torch import kernels
    q, k, v, mask, dout, lse, delta = _kernel_inputs(q, k, v, attn_mask,
                                                     dout, lse, delta)
    b, L, H, hd = q.shape
    S = k.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    if which == "fused":  # dq: 64-row tiles added by TMA reductions
        outs.append(torch.zeros((b, L, H, hd), **f32))
    elif which == "dq":
        outs.append(torch.empty_like(q))
    if which in ("fused", "dkv"):
        outs += [torch.empty((b, S, H, hd), **f32) for _ in range(2)]
        q, lib = _prescaled(q), "flash_bwd_kv"
    else:
        lib = "flash_bwd"
    qscale, scale = _scales(hd)
    status = getattr(_library(lib), f"moka_flash_bwd_{which}")(
        *(t.data_ptr() for t in (q, k, v, mask, dout, lse, delta, *outs)),
        *_dims(q, k, q_offset, causal), qscale, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(status, f"flash_bwd_{which}")
    return outs


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              attn_mask: torch.Tensor, q_offset: int = 0,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of flash attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  q (b, L, H, hd), k/v (b, S, K, hd),
    attn_mask (b, S) validity, q_offset = position of query 0 on the key
    axis (an int).  Not differentiable by itself: ``flash_mha`` is."""
    if is_rank_route(q, k):
        return flash_rank_fwd(q, k, v, attn_mask, q_offset, causal)
    if on_card(q, "flash attention"):
        return _launch_fwd(q, k, v, attn_mask, q_offset, causal)
    return flash_fwd_plain(q, k, v, attn_mask, q_offset, causal)


def flash_bwd_fused(q, k, v, attn_mask, dout, lse, delta, q_offset: int = 0,
                    causal: bool = True):
    """(dq in q's dtype, dk, dv fp32 GQA-summed (b, S, K, hd)) in one
    kernel: every (q, k) score, probability and dp is computed once for
    all three gradients.  Layouts as ``flash_bwd_plain``."""
    if not on_card(q, "flash attention"):
        return flash_bwd_plain(q, k, v, attn_mask, dout, lse, delta,
                               q_offset, causal)
    dq, dk, dv = _launch_bwd("fused", q, k, v, attn_mask, dout, lse, delta,
                             q_offset, causal)
    flash_bwd_fused.launches += 1
    kv_heads = k.shape[2]
    return (dq.to(q.dtype), _group_sum(dk, kv_heads),
            _group_sum(dv, kv_heads))


def flash_bwd_dq(q, k, v, attn_mask, dout, lse, delta, q_offset: int = 0,
                 causal: bool = True):
    """dq (b, L, H, hd) in q's dtype, given the global-row lse and delta
    (so it decomposes over key shards)."""
    if not on_card(q, "flash attention"):
        return flash_bwd_dq_plain(q, k, v, attn_mask, dout, lse, delta,
                                  q_offset, causal)
    (dq,) = _launch_bwd("dq", q, k, v, attn_mask, dout, lse, delta,
                        q_offset, causal)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, attn_mask, dout, lse, delta, q_offset: int = 0,
                  causal: bool = True):
    """(dk, dv) fp32 (b, S, K, hd), GQA-summed, given the global-row lse
    and delta."""
    if not on_card(q, "flash attention"):
        return flash_bwd_dkv_plain(q, k, v, attn_mask, dout, lse, delta,
                                   q_offset, causal)
    dk, dv = _launch_bwd("dkv", q, k, v, attn_mask, dout, lse, delta,
                         q_offset, causal)
    flash_bwd_dkv.launches += 1
    kv_heads = k.shape[2]
    return _group_sum(dk, kv_heads), _group_sum(dv, kv_heads)


# ------------------------------------------------------------ rank route

RANK_HEAD_DIMS = (4, 8, 16)  # the head dims flash_rank.cu is built for


def is_rank_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """MokA's rank-space attention: fp32, one head (H = KH = 1),
    head_dim <= 16."""
    return q.dtype == torch.float32 and q.shape[2] == 1 and \
        k.shape[2] == 1 and q.shape[-1] <= 16


_RANK_QSCALE = {hd: LOG2E / math.sqrt(hd) for hd in RANK_HEAD_DIMS}


def _rank_inputs(q, k, v, attn_mask, dout=None, lse=None, delta=None):
    """Check what the rank kernels take (fp32, one head of head_dim 4, 8 or
    16, one device, 16-byte aligned) and return the tensors contiguous, the
    mask as int32.  The checks run on every call, a wrapper runs three
    times a rank attention and 1,792 times a training step, so they are
    written out: a tensor that already passes is neither copied nor cast,
    and the loops that name the offending tensor run only on failure."""
    b, L, H, hd = q.shape
    S = k.shape[1]
    dev = q.device
    f32 = torch.float32
    ts = (q, k, v) if dout is None else (q, k, v, dout)
    if q.dtype != f32 or k.dtype != f32 or v.dtype != f32 or \
            (dout is not None and dout.dtype != f32):
        name, t = next((n, t) for n, t in zip("q k v dout".split(), ts)
                       if t.dtype != f32)
        raise TypeError(f"rank flash kernel takes fp32 tensors, {name} is "
                        f"{t.dtype}")
    if k.device != dev or v.device != dev or \
            (dout is not None and dout.device != dev):
        name, t = next((n, t) for n, t in zip("q k v dout".split(), ts)
                       if t.device != dev)
        raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if hd not in _RANK_QSCALE or H != 1 or k.shape != (b, S, 1, hd) or \
            v.shape != k.shape:
        raise ValueError(f"rank flash kernel takes one head of head_dim "
                         f"{RANK_HEAD_DIMS}: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if attn_mask.shape != (b, S):
        raise ValueError(f"attn_mask {tuple(attn_mask.shape)} != {(b, S)}")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if attn_mask.dtype != torch.int32 or attn_mask.device != dev or \
            not attn_mask.is_contiguous():
        attn_mask = attn_mask.to(device=dev, dtype=torch.int32).contiguous()
    out = [q, k, v, attn_mask]
    if dout is not None:
        out.append(dout.contiguous())
    if (q.data_ptr() | k.data_ptr() | v.data_ptr() |
            (0 if dout is None else out[4].data_ptr())) % 16:
        raise ValueError("rank flash kernel needs 16-byte aligned q, k, v, "
                         "dout")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if t.shape != (b, 1, L) or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}, want "
                             f"{(b, 1, L)} on {dev}")
        out.append(t.to(torch.float32).contiguous())
    return out


def _rank_check(status: int, fn: str) -> None:
    if status:
        from moka_tpu_torch import kernels
        kernels.check(status, f"flash_rank_{fn}")


def flash_rank_fwd(q, k, v, attn_mask, q_offset: int = 0,
                   causal: bool = True):
    """``flash_fwd`` on the rank route: (out (b, L, 1, hd) fp32, lse
    (b, 1, L) fp32) from the rank forward kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not on_card(q, "flash attention"):
        return flash_fwd_plain(q, k, v, attn_mask, q_offset, causal)
    q, k, v, mask = _rank_inputs(q, k, v, attn_mask)
    b, L, _, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, 1, L), dtype=torch.float32, device=q.device)
    # the q scale goes as a c_float, rounded to fp32 as ``_prescaled``
    # folds it for fp32 q
    _rank_check(_library("flash_rank").moka_flash_rank_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, L, k.shape[1], hd, int(q_offset),
        int(bool(causal)), _RANK_QSCALE[hd], raw_stream(q.device)), "fwd")
    flash_rank_fwd.launches += 1
    return out, lse


def flash_rank_bwd_dq(q, k, v, attn_mask, dout, lse, delta,
                      q_offset: int = 0, causal: bool = True):
    """dq (b, L, 1, hd) fp32 on the rank route, given the lse and delta."""
    if not on_card(q, "flash attention"):
        return flash_bwd_dq_plain(q, k, v, attn_mask, dout, lse, delta,
                                  q_offset, causal)
    q, k, v, mask, dout, lse, delta = _rank_inputs(q, k, v, attn_mask, dout,
                                                   lse, delta)
    b, L, _, hd = q.shape
    dq = torch.empty_like(q)
    _rank_check(_library("flash_rank").moka_flash_rank_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b,
        L, k.shape[1], hd, int(q_offset), int(bool(causal)),
        _RANK_QSCALE[hd], 1.0 / math.sqrt(hd), raw_stream(q.device)),
        "bwd_dq")
    flash_rank_bwd_dq.launches += 1
    return dq


def flash_rank_bwd_dkv(q, k, v, attn_mask, dout, lse, delta,
                       q_offset: int = 0, causal: bool = True):
    """(dk, dv) (b, S, 1, hd) fp32 on the rank route, given the lse and
    delta."""
    if not on_card(q, "flash attention"):
        return flash_bwd_dkv_plain(q, k, v, attn_mask, dout, lse, delta,
                                   q_offset, causal)
    q, k, v, mask, dout, lse, delta = _rank_inputs(q, k, v, attn_mask, dout,
                                                   lse, delta)
    b, L, _, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(k)
    _rank_check(_library("flash_rank").moka_flash_rank_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, L, k.shape[1], hd, int(q_offset),
        int(bool(causal)), _RANK_QSCALE[hd], raw_stream(q.device)),
        "bwd_dkv")
    flash_rank_bwd_dkv.launches += 1
    return dk, dv


# kernel launches (CUDA tensors only); the forward's also by head_dim
flash_fwd.launches = 0
flash_fwd.launches_by_head_dim = {}
flash_bwd_fused.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_rank_fwd.launches = 0
flash_rank_bwd_dq.launches = 0
flash_rank_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, mask, out, lse); backward forms delta in
    fp32 and runs the fused kernel or the dq + dkv pair (the rank route:
    always its dq + dk/dv pair)."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, q_offset, causal, residuals):
        if residuals is not None and "flash_out" in residuals:
            # a remat recompute: the forward's own residuals, no kernel
            out = residuals["flash_out"].detach()
            lse = residuals["flash_lse"].detach()
        else:
            out, lse = flash_fwd(q, k, v, attn_mask, q_offset, causal)
            if residuals is not None:
                residuals["flash_out"] = out.detach()
                residuals["flash_lse"] = lse.detach()
        ctx.save_for_backward(q, k, v, attn_mask, out, lse)
        ctx.q_offset, ctx.causal = q_offset, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, attn_mask, out, lse = ctx.saved_tensors
        args = (ctx.q_offset, ctx.causal)
        dout = dout.to(q.dtype)
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if is_rank_route(q, k):
            dq = flash_rank_bwd_dq(q, k, v, attn_mask, dout, lse, delta,
                                   *args)
            dk, dv = flash_rank_bwd_dkv(q, k, v, attn_mask, dout, lse,
                                        delta, *args)
        elif use_fused_bwd(q.shape[1], k.shape[1]):
            dq, dk, dv = flash_bwd_fused(q, k, v, attn_mask, dout, lse,
                                         delta, *args)
        else:
            dq = flash_bwd_dq(q, k, v, attn_mask, dout, lse, delta, *args)
            dk, dv = flash_bwd_dkv(q, k, v, attn_mask, dout, lse, delta,
                                   *args)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              attn_mask: torch.Tensor, q_offset: int = 0,
              causal: bool = True, residuals: dict | None = None
              ) -> torch.Tensor:
    """Drop-in for ``ops.attention.mha`` with the mask given as a (b, S)
    validity vector: returns (b, L, H, hd), differentiable in q, k, v.

    residuals: the forward's output and lse under the JAX tag names
    ``flash_out`` and ``flash_lse`` (``moka_tpu/ops/flash_attention.py``
    names them for the remat policies): a dict without them is filled; a
    dict with them is used instead of running the forward, as a remat
    recompute that kept them does (``models.llama``, the ``*_lse``
    policies)."""
    return _FlashAttention.apply(q, k, v, attn_mask, q_offset, causal,
                                 residuals)
