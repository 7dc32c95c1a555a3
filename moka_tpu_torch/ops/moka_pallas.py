"""Fused MokA adapter delta (port of ``moka_tpu/ops/moka_pallas.py``).

For a token tile the kernel computes the per-modality down projections,
the rank-space attention of each non-text stream against the question
keys and the shared up projection, with one read of x and one write of the
delta: the (M, b, L, r) rank tensor and the scores stay on chip.  On a CUDA
tensor ``moka_delta_fused`` launches ``kernels/csrc/moka_delta_fwd.cu`` (or
raises); on a CPU tensor it runs ``moka_delta_fused_plain``, the kernel's
arithmetic in plain torch.  The JAX code computes the question keys as a
plain fp32 product over every token; the CUDA source computes them in a
first, small kernel that reads x only on question tokens.

The kernel works in fp32 from x's storage type; it does not round A to
bf16 as the TPU kernel does.  Gradients: the backward is autograd through
the plain ``moka_delta``, exact and without a backward kernel, as the JAX
custom VJP does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from moka_tpu_torch.ops.moka import MokaSpec, moka_delta

NEG_INF = -1e30
_MAX_MODALITIES = 4


def _question_keys(x, lora_a, modality_masks, question_mask,
                   spec: MokaSpec) -> torch.Tensor:
    """(b, L, r) fp32 keys: the text stream's A output on question tokens."""
    keys = torch.einsum("bld,dr->blr", x.float(), lora_a[0].float())
    qm = modality_masks[0].float() * question_mask.float()
    return keys * qm[..., None] * spec.pre_scale


def moka_delta_fused_plain(x, lora_a, lora_b, modality_masks, question_mask,
                           spec: MokaSpec) -> torch.Tensor:
    """What the fused kernel computes, in plain torch (fp32 math)."""
    keys = _question_keys(x, lora_a, modality_masks, question_mask, spec)
    masks = modality_masks.float()
    qmask = question_mask.float()
    xf, a, b_mat = x.float(), lora_a.float(), lora_b.float()
    has_q = qmask.sum(dim=-1) > 0
    attn_scale = 1.0 / math.sqrt(spec.rank)
    buf = None
    for i in range(spec.num_modalities):
        a_i = (xf @ a[i]) * masks[i][..., None] * spec.pre_scale
        buf = a_i if buf is None else buf + a_i
        if i in spec.attn_modalities:
            s = torch.einsum("blr,bkr->blk", a_i, keys) * attn_scale
            s = torch.where(qmask[:, None, :] > 0, s, s.new_tensor(NEG_INF))
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


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        lib = kernels.library("moka_delta_fwd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.moka_delta_fwd.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i,
                                       i, f, f, i, f, f, f, f, i, p]
        lib.moka_delta_fwd.restype = i
        _lib = lib
    return _lib


def _launch(x, lora_a, lora_b, modality_masks, question_mask,
            spec: MokaSpec) -> torch.Tensor:
    from moka_tpu_torch import kernels
    b, L, d_in = x.shape
    m, _, r = lora_a.shape
    d_out = lora_b.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused MokA kernel takes bf16 or fp32 x, not "
                        f"{x.dtype}")
    if m != spec.num_modalities or r != spec.rank or m > _MAX_MODALITIES:
        raise ValueError(f"adapter shape {tuple(lora_a.shape)} vs {spec}")
    if r != 4 or d_in % 8 or d_out % 2:
        raise ValueError(f"fused MokA kernel needs rank 4, d_in % 8 == 0 "
                         f"and even d_out (got r={r}, {d_in}->{d_out})")
    if tuple(lora_b.shape) != (r, d_out) or lora_a.shape[1] != d_in:
        raise ValueError(f"bad adapter shapes {tuple(lora_a.shape)}, "
                         f"{tuple(lora_b.shape)} for d_in {d_in}")
    if tuple(modality_masks.shape) != (m, b, L) or \
            tuple(question_mask.shape) != (b, L):
        raise ValueError("mask shapes do not match x")
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    x = x.contiguous()
    keys = torch.empty((b, L, r), **f32)  # written by the kernel's key pass
    masks = modality_masks.to(**f32).contiguous()
    qmask = question_mask.to(**f32).contiguous()
    a = lora_a.to(**f32).contiguous()
    b_mat = lora_b.to(**f32).contiguous()
    if any(t.data_ptr() % 16 for t in (x, a, b_mat)):
        raise ValueError("fused MokA kernel needs 16-byte aligned x, A, B")
    out = torch.empty((b, L, d_out), dtype=x.dtype, device=dev)
    post = list(spec.post_scales or ()) + [0.0] * _MAX_MODALITIES
    attn_bits = sum(1 << i for i in spec.attn_modalities)
    status = _library().moka_delta_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), masks.data_ptr(),
        qmask.data_ptr(), keys.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
        out.data_ptr(), b, L, d_in, d_out, m, r, float(spec.pre_scale),
        float(spec.attn_weight), attn_bits, *map(float, post[:4]),
        int(spec.post_scales is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(status, "moka_delta_fwd")
    moka_delta_fused.launches += 1
    return out


def _forward(x, lora_a, lora_b, modality_masks, question_mask, spec):
    if x.device.type == "cuda":
        return _launch(x, lora_a, lora_b, modality_masks, question_mask, spec)
    if x.device.type == "cpu":
        return moka_delta_fused_plain(x, lora_a, lora_b, modality_masks,
                                      question_mask, spec)
    raise ValueError(f"no fused MokA delta for device {x.device}")


class _FusedDelta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lora_a, lora_b, modality_masks, question_mask, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, lora_a, lora_b, modality_masks,
                              question_mask)
        return _forward(x, lora_a, lora_b, modality_masks, question_mask,
                        spec)

    @staticmethod
    def backward(ctx, g):
        x, lora_a, lora_b, modality_masks, question_mask = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True)
                  for t in (x, lora_a, lora_b)]
        with torch.enable_grad():
            out = moka_delta(*inputs, modality_masks, question_mask,
                             ctx.spec)
        dx, da, db = torch.autograd.grad(out, inputs, g)
        return dx, da, db, None, None, None


def moka_delta_fused(x, lora_a, lora_b, modality_masks, question_mask,
                     spec: MokaSpec) -> torch.Tensor:
    """Fused MokA delta, same contract as ``moka.moka_delta`` without
    dropout: in training the caller passes the dropped-out x
    (``models.llama._apply_proj``), as the JAX package does."""
    return _FusedDelta.apply(x, lora_a, lora_b, modality_masks,
                             question_mask, spec)


moka_delta_fused.launches = 0  # kernel launches (CUDA tensors only)
