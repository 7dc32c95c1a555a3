"""Fused MokA adapter delta (port of ``moka_tpu/ops/moka_pallas.py``).

For a token tile the kernel computes the per-modality down projections,
the rank-space attention of each non-text stream against the question
keys and the shared up projection, with one read of x and one write of the
delta: the (M, b, L, r) rank tensor and the scores stay on chip.  On a CUDA
tensor ``moka_delta_fused`` launches ``kernels/csrc/moka_delta_fwd.cu`` (or
raises); on a CPU tensor it runs ``moka_delta_fused_plain``, the kernel's
arithmetic in plain torch.  The JAX code computes the question keys as a
plain fp32 product over every token; the CUDA source computes them in a
first, small kernel (the key pass) that reads x only on question tokens
and writes each row's keys contiguously, which the main kernel walks.

The kernel takes every rank with at most four modalities
(``fused_moka_supported``).  Ranks 1-64 run the persistent kernel, built
for ranks 4, 8, 16, 32 and 64: a rank between runs in the next built one
with A's columns and B's rows past it zero (exact) and the attention scale
of the true rank.  Past 64 kernel 5 is a chain of hand-written launches
(``moka_delta_fwd.cu``'s wide path): a down product writes every
modality's a_i and the question keys, the rank flash forward R1
(``flash_rank.cu`` at head_dim r) attends for each attention stream, and
an up product forms the rank-space buffer and its product with B (for
bf16 x both products on the tensor cores); the rank is padded to a
multiple of 64 the same way.  On the card the wrapper raises on any
other spec; on the CPU the plain version takes any spec, as the JAX
kernel does.  It keeps A in fp32 in effect (bf16 x: A split into two
bf16 halves on the tensor cores, at every rank; fp32 x: fp32 FMAs); it
does not round A to bf16 as the TPU kernel does.  Under context
parallelism (``gather_keys``) each rank computes its rows' question keys
(the key pass alone, or the wide path's down product), gathers them over
the sequence group and attends to all of them under the whole sequence's
question mask (``key_question``), as ``moka.moka_delta`` does.
Gradients: the backward is autograd through the plain ``moka_delta``
(with the same gathered keys), exact and without a backward kernel, as
the JAX custom VJP does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from moka_tpu_torch.ops.flash_attention import (flash_rank_fwd_into,
                                                rank_built_dim)
from moka_tpu_torch.ops.moka import MokaSpec, moka_delta

NEG_INF = -1e30
_MAX_MODALITIES = 4
KERNEL_RANKS = (4, 8, 16, 32, 64)  # the persistent kernel's instances


def kernel_rank(rank: int) -> int:
    """The rank the kernels run ``rank`` at: the smallest built one at
    least as large up to 64, past it the head dim R1 runs at (the next
    multiple of 64), which the wide path's products share."""
    if rank > KERNEL_RANKS[-1]:
        return rank_built_dim(rank)
    return next(r for r in KERNEL_RANKS if r >= rank)


def fused_moka_supported(spec: MokaSpec | None, d_in: int | None = None,
                         d_out: int | None = None) -> bool:
    """Whether the fused kernel takes ``spec`` (any rank, one to four
    modalities) and, where they are given, these widths (d_in and d_out
    multiples of 8, the TMA rows' 16-byte strides).  The default route of
    the decode paths asks this before any launch; on the card the wrapper
    raises on a spec it refuses."""
    if spec is None or spec.rank < 1 or \
            not 1 <= spec.num_modalities <= _MAX_MODALITIES:
        return False
    return d_in is None or (d_in % 8 == 0 and d_out % 8 == 0)


def _question_keys(x, lora_a, modality_masks, question_mask,
                   spec: MokaSpec) -> torch.Tensor:
    """(b, L, r) fp32 keys: the text stream's A output on question tokens."""
    keys = torch.einsum("bld,dr->blr", x.float(), lora_a[0].float())
    qm = modality_masks[0].float() * question_mask.float()
    return keys * qm[..., None] * spec.pre_scale


def moka_delta_fused_plain(x, lora_a, lora_b, modality_masks, question_mask,
                           spec: MokaSpec, keys=None, key_mask=None
                           ) -> torch.Tensor:
    """What the fused kernel computes, in plain torch (fp32 math).
    ``keys`` (b, S, r) and ``key_mask`` (b, S): the question keys to attend
    to and where they sit (a ring's gathered keys and the whole sequence's
    question mask), instead of x's own."""
    if keys is None:
        keys = _question_keys(x, lora_a, modality_masks, question_mask, spec)
        key_mask = question_mask
    masks = modality_masks.float()
    kmask = key_mask.float()
    xf, a, b_mat = x.float(), lora_a.float(), lora_b.float()
    keys = keys.float()
    has_q = kmask.sum(dim=-1) > 0
    attn_scale = 1.0 / math.sqrt(spec.rank)
    buf = None
    for i in range(spec.num_modalities):
        a_i = (xf @ a[i]) * masks[i][..., None] * spec.pre_scale
        buf = a_i if buf is None else buf + a_i
        if i in spec.attn_modalities:
            s = torch.einsum("blr,bkr->blk", a_i, keys) * attn_scale
            s = torch.where(kmask[:, None, :] > 0, s, s.new_tensor(NEG_INF))
            p = torch.softmax(s, dim=-1)
            p = torch.where(has_q[:, None, None], p, p.new_zeros(()))
            attn = torch.einsum("blk,bkr->blr", p, keys)
            buf = buf + masks[i][..., None] * (spec.attn_weight * attn)
    delta = buf @ b_mat
    if spec.post_scales is not None:
        post = sum(masks[i] * ps for i, ps in enumerate(spec.post_scales))
        delta = delta * post[..., None]
    return delta.to(x.dtype)


_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (moka_delta_fwd.cu built, or an edited copy of it) with its
    entry points' argument types set."""
    p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
    lib.moka_delta_fwd.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i,
                                   i, f, f, i, f, f, f, f, i, p, p, i, p]
    lib.moka_delta_fwd.restype = i
    lib.moka_delta_workspace.argtypes = [i, i, i, i, i, i, i, i, i]
    lib.moka_delta_workspace.restype = n
    lib.moka_delta_keys.argtypes = [p, i, p, p, p, p, i, i, i, i, i, f, p]
    lib.moka_delta_keys.restype = i
    lib.moka_delta_wide_down.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i,
                                         f, p]
    lib.moka_delta_wide_down.restype = i
    lib.moka_delta_wide_up.argtypes = [p, p, p, p, p, i, p, p, i, i, i, i, f,
                                       i, f, f, f, f, i, p]
    lib.moka_delta_wide_up.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        _lib = bind(kernels.library("moka_delta_fwd"))
    return _lib


def _checked(x, lora_a, lora_b, modality_masks, question_mask,
             spec: MokaSpec):
    """Check what kernel 5 takes and return x contiguous, the masks as
    fp32, and A and B fp32 padded to the rank the kernels run at
    (``kernel_rank``: the columns of A and rows of B past the true rank
    zero)."""
    b, L, d_in = x.shape
    m, _, r = lora_a.shape
    d_out = lora_b.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused MokA kernel takes bf16 or fp32 x, not "
                        f"{x.dtype}")
    if m != spec.num_modalities or r != spec.rank:
        raise ValueError(f"adapter shape {tuple(lora_a.shape)} vs {spec}")
    if not fused_moka_supported(spec):
        raise ValueError(f"the fused MokA kernel takes 1-{_MAX_MODALITIES} "
                         f"modalities, not rank {spec.rank} with "
                         f"{spec.num_modalities}")
    if not fused_moka_supported(spec, d_in, d_out):
        raise ValueError(f"fused MokA kernel needs d_in and d_out multiples "
                         f"of 8 (got {d_in}->{d_out})")
    if tuple(lora_b.shape) != (r, d_out) or lora_a.shape[1] != d_in:
        raise ValueError(f"bad adapter shapes {tuple(lora_a.shape)}, "
                         f"{tuple(lora_b.shape)} for d_in {d_in}")
    if tuple(modality_masks.shape) != (m, b, L) or \
            tuple(question_mask.shape) != (b, L):
        raise ValueError("mask shapes do not match x")
    f32 = dict(device=x.device, dtype=torch.float32)
    x = x.contiguous()
    masks = modality_masks.to(**f32).contiguous()
    qmask = question_mask.to(**f32).contiguous()
    kr = kernel_rank(r)
    a, b_mat = lora_a.to(**f32), lora_b.to(**f32)
    if kr != r:
        a = torch.nn.functional.pad(a, (0, kr - r))
        b_mat = torch.nn.functional.pad(b_mat, (0, 0, 0, kr - r))
    a, b_mat = a.contiguous(), b_mat.contiguous()
    if any(t.data_ptr() % 16 for t in (x, a, b_mat)):
        raise ValueError("fused MokA kernel needs 16-byte aligned x, A, B")
    return x, masks, qmask, a, b_mat


def _post(spec: MokaSpec) -> tuple:
    post = list(spec.post_scales or ()) + [0.0] * _MAX_MODALITIES
    return (*map(float, post[:4]), int(spec.post_scales is not None))


def _launch(x, lora_a, lora_b, modality_masks, question_mask,
            spec: MokaSpec, key_question=None, gather_keys=None
            ) -> torch.Tensor:
    from moka_tpu_torch import kernels
    x, masks, qmask, a, b_mat = _checked(x, lora_a, lora_b, modality_masks,
                                         question_mask, spec)
    if spec.rank > KERNEL_RANKS[-1]:
        return _launch_wide(x, masks, qmask, a, b_mat, spec, key_question,
                            gather_keys)
    b, L, d_in = x.shape
    m, _, kr = a.shape
    d_out = b_mat.shape[1]
    dev = x.device
    lib = _library()
    bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ext, kmask, kl = None, None, L
    if gather_keys is not None:
        # this rank's rows' keys by the key pass alone, gathered over the
        # sequence group; the main launch compacts the gathered rows
        dense = torch.zeros((b, L, kr), device=dev, dtype=torch.float32)
        kernels.check(lib.moka_delta_keys(
            x.data_ptr(), bf16, masks.data_ptr(), qmask.data_ptr(),
            a.data_ptr(), dense.data_ptr(), b, L, d_in, m, kr,
            float(spec.pre_scale), stream), "moka_delta_keys")
        moka_delta_fused.keys_launches += 1
        ext = gather_keys(dense).contiguous()
        kmask = key_question.to(device=dev, dtype=torch.float32).contiguous()
        kl = kmask.shape[1]
        if tuple(ext.shape) != (b, kl, kr):
            raise ValueError(f"gathered keys {tuple(ext.shape)} for a "
                             f"question mask {tuple(kmask.shape)}")
    # the key pass's keys and counts and, for bf16 x, A's and B's bf16
    # halves: written by the kernels before they are read
    work = torch.empty(lib.moka_delta_workspace(b, L, kl, d_in, d_out, m,
                                                kr, bf16, int(ext is not None)),
                       dtype=torch.uint8, device=dev)
    out = torch.empty((b, L, d_out), dtype=x.dtype, device=dev)
    attn_bits = sum(1 << i for i in spec.attn_modalities)
    status = lib.moka_delta_fwd(
        x.data_ptr(), bf16, masks.data_ptr(), qmask.data_ptr(), a.data_ptr(),
        b_mat.data_ptr(), out.data_ptr(), work.data_ptr(), b, L, d_in, d_out,
        m, kr, spec.rank, float(spec.pre_scale), float(spec.attn_weight),
        attn_bits, *_post(spec), None if ext is None else ext.data_ptr(),
        None if kmask is None else kmask.data_ptr(), kl, stream)
    kernels.check(status, "moka_delta_fwd")
    moka_delta_fused.launches += 1
    return out


def _launch_wide(x, masks, qmask, a, b_mat, spec: MokaSpec, key_question,
                 gather_keys) -> torch.Tensor:
    """Kernel 5 past rank 64: the down product (every a_i and the question
    keys), R1 at head_dim ``kernel_rank(r)`` for each attention stream
    (the keys gathered over the sequence group under a ring), the up
    product.  A and B come padded to that rank.  For bf16 x each product
    entry also splits its operands into bf16 halves (A's; buf's and B's)
    in scratch allocated here, for the tensor cores."""
    from moka_tpu_torch import kernels
    b, L, d_in = x.shape
    m, _, rp = a.shape
    d_out = b_mat.shape[1]
    T, dev = b * L, x.device
    lib = _library()
    bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = dict(device=dev, dtype=torch.float32)
    a_all = torch.empty((m, T, rp), **f32)
    keys = torch.empty((b, L, rp), **f32)

    def halves(*shape):  # bf16 x: the products' operands' bf16 halves
        return torch.empty(shape, device=dev, dtype=torch.bfloat16) \
            if bf16 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    at = halves(2 * m * rp, d_in)
    kernels.check(lib.moka_delta_wide_down(
        x.data_ptr(), bf16, a.data_ptr(), masks.data_ptr(), qmask.data_ptr(),
        a_all.data_ptr(), keys.data_ptr(), ptr(at), T, d_in, m, rp,
        float(spec.pre_scale), stream), "moka_delta_wide_down")
    del at
    moka_delta_fused.wide_down_launches += 1
    kmask = qmask
    if gather_keys is not None:
        keys = gather_keys(keys).contiguous()
        kmask = key_question
    kmask = kmask.to(device=dev, dtype=torch.int32).contiguous()
    S = keys.shape[1]
    if tuple(keys.shape) != (b, S, rp) or tuple(kmask.shape) != (b, S):
        raise ValueError(f"keys {tuple(keys.shape)} for a question mask "
                         f"{tuple(kmask.shape)}")
    streams = sorted(spec.attn_modalities)
    attn = torch.empty((max(len(streams), 1), T, rp), **f32)
    lse = torch.empty((b, 1, L), **f32)
    # R1 on the padded tensors with the true rank's scale, each stream's
    # output into its slice of ``attn``
    k4 = keys.view(b, S, 1, rp)
    for j, i in enumerate(streams):
        flash_rank_fwd_into(a_all[i].view(b, L, 1, rp), k4, k4, kmask,
                            attn[j].view(b, L, 1, rp), lse, spec.rank,
                            causal=False)
    out = torch.empty((b, L, d_out), dtype=x.dtype, device=dev)
    attn_bits = sum(1 << i for i in streams)
    bufs, bs = halves(T, 2 * rp), halves(2 * rp, d_out)
    kernels.check(lib.moka_delta_wide_up(
        a_all.data_ptr(), attn.data_ptr(), masks.data_ptr(),
        b_mat.data_ptr(), out.data_ptr(), bf16, ptr(bufs), ptr(bs), T, d_out,
        m, rp, float(spec.attn_weight), attn_bits, *_post(spec), stream),
        "moka_delta_wide_up")
    moka_delta_fused.wide_up_launches += 1
    return out


def _forward(x, lora_a, lora_b, modality_masks, question_mask, spec,
             key_question=None, gather_keys=None):
    if x.device.type == "cuda":
        return _launch(x, lora_a, lora_b, modality_masks, question_mask,
                       spec, key_question, gather_keys)
    if x.device.type == "cpu":
        keys = key_mask = None
        if gather_keys is not None:
            keys = gather_keys(_question_keys(x, lora_a, modality_masks,
                                              question_mask, spec))
            key_mask = key_question
        return moka_delta_fused_plain(x, lora_a, lora_b, modality_masks,
                                      question_mask, spec, keys, key_mask)
    raise ValueError(f"no fused MokA delta for device {x.device}")


class _FusedDelta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lora_a, lora_b, modality_masks, question_mask, spec,
                key_question, gather_keys):
        ctx.spec, ctx.gather_keys = spec, gather_keys
        ctx.save_for_backward(x, lora_a, lora_b, modality_masks,
                              question_mask, key_question)
        return _forward(x, lora_a, lora_b, modality_masks, question_mask,
                        spec, key_question, gather_keys)

    @staticmethod
    def backward(ctx, g):
        x, lora_a, lora_b, modality_masks, question_mask, key_question = \
            ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True)
                  for t in (x, lora_a, lora_b)]
        # under a ring the gathered keys' gradient goes home through the
        # gather's backward (each rank runs it: a collective)
        with torch.enable_grad():
            out = moka_delta(*inputs, modality_masks, question_mask,
                             ctx.spec, key_question=key_question,
                             gather_keys=ctx.gather_keys)
        dx, da, db = torch.autograd.grad(out, inputs, g)
        return dx, da, db, None, None, None, None, None


def moka_delta_fused(x, lora_a, lora_b, modality_masks, question_mask,
                     spec: MokaSpec, *, key_question=None,
                     gather_keys=None) -> torch.Tensor:
    """Fused MokA delta, same contract as ``moka.moka_delta`` without
    dropout: in training the caller passes the dropped-out x
    (``models.llama._apply_proj``), as the JAX package does.
    ``key_question``, ``gather_keys``: context parallelism, as
    ``moka.moka_delta``'s (x is one shard of the sequence)."""
    if (key_question is None) != (gather_keys is None):
        raise ValueError("context parallelism takes both key_question and "
                         "gather_keys")
    return _FusedDelta.apply(x, lora_a, lora_b, modality_masks,
                             question_mask, spec, key_question, gather_keys)


# kernel launches (CUDA tensors only), each counted where it is made:
# ``launches`` the ``moka_delta_fwd`` entry's (ranks 1-64: the key pass and
# the persistent kernel, one launch of the entry), ``keys_launches`` the
# key pass alone under a ring (``moka_delta_keys``), and past rank 64 the
# wide path's down and up products (its R1 launches count as
# ``flash_rank_fwd``'s)
moka_delta_fused.launches = 0
moka_delta_fused.keys_launches = 0
moka_delta_fused.wide_down_launches = 0
moka_delta_fused.wide_up_launches = 0
