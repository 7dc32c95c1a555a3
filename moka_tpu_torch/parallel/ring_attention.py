"""Ring attention: context-parallel causal attention over a sequence group
(port of ``moka_tpu/parallel/ring_attention.py``).

The sequence is split over the ranks of a mesh axis: each rank keeps its
query shard and passes k/v shards round the ring (``comm.ring_exchange``
to the next rank, ``dist.batch_isend_irecv``).  Each visited shard gives a
normalized partial ``(out_j, lse_j)``, merged by the exact log-sum-exp
rule

    lse = logaddexp(lse_a, lse_b)
    out = out_a * exp(lse_a - lse) + out_b * exp(lse_b - lse)

JAX takes global arrays and splits them with ``shard_map``; here each rank
passes its own shards, (b, L_shard, H|K, hd) q, k, v and the (b, L_shard)
key mask, shard ``idx`` holding global positions [idx * L_shard, (idx + 1)
* L_shard), and gets its shard of the output.

``make_ring_attention`` is the dense ring: plain ops on each shard pair,
with autograd through the hand-offs (``comm.ring_shift``).
``make_ring_flash_attention`` runs the flash kernels: kernel 1
(``ops.flash_attention.flash_fwd``) on every visited shard, and a second
ring in the backward that adds ``flash_bwd_dq`` (kernel 3) into dq and
``flash_bwd_dkv`` (kernel 4) into the travelling shard's (dk, dv), given
the global lse and ``delta = sum(dout * out)``; the accumulated (dk, dv)
travel the whole ring home.  Like JAX it uses kernels 3 and 4, never the
fused backward (kernel 2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from moka_tpu_torch.ops.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                                flash_fwd)
from moka_tpu_torch.parallel import comm

NEG_INF = -1e30


def _block_attn(q, k, v, key_mask, q_start: int, k_start: int,
                scale: float):
    """Normalized partial attention of a q shard against one k/v shard.

    q: (b, Lq, H, hd); k/v: (b, Lk, K, hd); key_mask: (b, Lk) validity.
    Returns (out (b, Lq, H, hd) fp32, lse (b, Lq, H) fp32); rows that see no
    key give out 0 and lse NEG_INF (no weight in the merge)."""
    b, Lq, H, hd = q.shape
    Lk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(b, Lq, K, G, hd).float()
    s = torch.einsum("blkgh,bskh->bkgls", qg, k.float()) * scale
    q_ids = q_start + torch.arange(Lq, device=q.device)
    k_ids = k_start + torch.arange(Lk, device=q.device)
    ok = (q_ids[:, None] >= k_ids[None, :])[None, None, None] & \
        (key_mask[:, None, None, None, :] > 0)
    s = torch.where(ok, s, s.new_tensor(NEG_INF))
    m = s.amax(dim=-1)                                     # (b, K, G, Lq)
    p = torch.where(ok, torch.exp(s - m[..., None]), s.new_zeros(()))
    l_sum = p.sum(dim=-1)
    any_valid = l_sum > 0
    out = torch.einsum("bkgls,bskh->blkgh",
                       p / torch.clamp(l_sum, min=1e-30)[..., None],
                       v.float())
    lse = torch.where(any_valid, m + torch.log(torch.clamp(l_sum, min=1e-30)),
                      s.new_tensor(NEG_INF))
    lse = lse.permute(0, 3, 1, 2).reshape(b, Lq, H)
    valid = any_valid.permute(0, 3, 1, 2).reshape(b, Lq, H)
    out = torch.where(valid[..., None], out.reshape(b, Lq, H, hd),
                      out.new_zeros(()))
    return out, lse


def _merge(out_a, lse_a, out_b, lse_b):
    """Merge two normalized partials; lse (b, L, H) against out (b, L, H,
    hd)."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse)
    wb = torch.exp(lse_b - lse)
    return out_a * wa[..., None] + out_b * wb[..., None], lse


def _pad_seq(x: torch.Tensor, mult: int, axis: int = 1) -> torch.Tensor:
    L = x.shape[axis]
    Lp = -(-L // mult) * mult
    if Lp == L:
        return x
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, Lp - L]
    return F.pad(x, pad)


def _seq_group(mesh, axis: str):
    """(group, size, this rank's index) of mesh axis ``axis``."""
    group = mesh.get_group(axis)
    return group, comm.group_size(group), mesh.get_local_rank(axis)


def make_ring_attention(mesh, axis: str = "seq"):
    """ring(q, k, v, attn_mask) over this rank's shards (b, L, H|K, hd) and
    (b, L): causal over global positions, differentiable, output this
    rank's (b, L, H, hd) shard in q's dtype."""
    group, n, idx = _seq_group(mesh, axis)

    def ring(q, k, v, attn_mask):
        b, Lq, H, hd = q.shape
        scale = 1.0 / math.sqrt(hd)
        acc = q.new_zeros((b, Lq, H, hd), dtype=torch.float32)
        lse = q.new_full((b, Lq, H), NEG_INF, dtype=torch.float32)
        k_s, v_s, mask_s = k, v, attn_mask
        for step in range(n):
            src = (idx - step) % n
            out_j, lse_j = _block_attn(q, k_s, v_s, mask_s, idx * Lq,
                                       src * Lq, scale)
            acc, lse = _merge(acc, lse, out_j, lse_j)
            if step < n - 1:
                k_s, v_s = comm.ring_shift(group, k_s, v_s)
                (mask_s,) = comm.ring_exchange([mask_s], group)
        return acc.to(q.dtype)

    return ring


def _ring_fwd(group, n, idx, q, k, v, key_mask, l_true):
    """The flash forward ring: (out (b, L, H, hd) fp32, lse (b, H, L), the
    kernels' layout)."""
    b, Lq, H, hd = q.shape
    acc = q.new_zeros((b, Lq, H, hd), dtype=torch.float32)
    lse = q.new_full((b, Lq, H), NEG_INF, dtype=torch.float32)
    kv = [k, v, key_mask]
    for step in range(n):
        src = (idx - step) % n
        # the kernel's query positions are relative to THIS k shard's start;
        # the offsets use the unpadded shard length (padded queries are cut
        # off, padded keys masked)
        out_j, lse_j = flash_fwd(q, kv[0], kv[1], kv[2],
                                 q_offset=(idx - src) * l_true, causal=True)
        acc, lse = _merge(acc, lse, out_j.float(), lse_j.transpose(1, 2))
        if step < n - 1:
            kv = comm.ring_exchange(kv, group)
    return acc, lse.transpose(1, 2).contiguous()


def _ring_bwd(group, n, idx, q, k, v, key_mask, dout, lse, delta, l_true):
    """The flash backward ring: (dq, dk, dv) in fp32."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kv = [k, v, key_mask]
    for step in range(n):
        src = (idx - step) % n
        qoff = (idx - src) * l_true
        dq += flash_bwd_dq(q, kv[0], kv[1], kv[2], dout, lse, delta, qoff,
                           True).float()
        dkj, dvj = flash_bwd_dkv(q, kv[0], kv[1], kv[2], dout, lse, delta,
                                 qoff, True)
        dk += dkj
        dv += dvj
        # n hand-offs of the gradients: each shard's arrive home; k/v move
        # only while another rank still needs them
        if step < n - 1:
            kv = comm.ring_exchange(kv, group)
        dk, dv = comm.ring_exchange([dk, dv], group)
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, group, n, idx, l_true):
        acc, lse = _ring_fwd(group, n, idx, q, k, v, key_mask, l_true)
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.ring = (group, n, idx, l_true)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
        dq, dk, dv = _ring_bwd(*ctx.ring[:3], q, k, v, key_mask, dout, lse,
                               delta.contiguous(), ctx.ring[3])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def make_ring_flash_attention(mesh, axis: str = "seq", block_q: int = 512,
                              block_k: int = 512):
    """``make_ring_attention``'s contract through the flash kernels (the
    plain flash versions on CPU tensors).  Each shard is padded to a
    multiple of min(block_q, block_k, L): padded keys are masked, padded
    queries cut off."""
    group, n, idx = _seq_group(mesh, axis)

    def ring(q, k, v, attn_mask):
        L = q.shape[1]
        blk = min(block_q, block_k, L)
        q_p, k_p, v_p = (_pad_seq(t, blk) for t in (q, k, v))
        mask_p = _pad_seq(attn_mask.to(torch.int32), blk)
        out = _RingFlash.apply(q_p, k_p, v_p, mask_p, group, n, idx, L)
        return out[:, :L]

    return ring
