"""LoRA dropout fused into the adapter's A projection (port of
``moka_tpu/ops/fused_dropout.py``).

``dropout_a_proj(x, lora_a, key, rate)`` is
``einsum('bld,mdr->mblr', lora_dropout(x), lora_a)`` in fp32 without the
dropped-out x, the random bits or the mask ever reaching device memory: the
forward kernel reads x once, draws the bits in the kernel and writes only
the (N, M*r) rank projection; the backward kernel draws the same bits again
and writes dx and dA.  On a CUDA tensor ``dropout_a_fwd`` and
``dropout_a_bwd`` launch the kernels of ``kernels/csrc/fused_dropout.cu``
(TPU kernels 6 and 7) or raise; on a CPU tensor they run
``dropout_a_fwd_plain`` / ``dropout_a_bwd_plain``, the same arithmetic in
plain torch.

The bits: 32-bit words compared with ``threshold(rate)``, as the JAX kernel
compares them.  Element (n, c) of the (N, d) input takes word c % 4 of
Philox4x32-10 at counter (n, c // 4) under the key's ``philox_key``
(``core.rng.DropoutKey.bits32`` computes the same words in plain torch), so
the mask depends on the key alone: the forward, its remat recompute and the
backward drop the same elements whatever the tiling.  The TPU kernel seeds
its generator per row block instead, and JAX's interpret mode (the CPU)
draws ``jax.random.bits(key, (N, d), uint32)``; the parity tests hand the
port those words through the key's ``bits32``, or through ``_force_bits``,
which both the plain versions and the kernels take.

Numerics, as the JAX kernels: forward ``x_d = where(keep, x * (1/keep
rounded to x's dtype), 0)`` in x's dtype, then the product in fp32;
backward ``m = where(keep, 1/keep in fp32, 0)``, ``dx = ((g @ A^T) *
m)`` in x's dtype and ``dA = (x * m)^T @ g`` in fp32, cast to A's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from moka_tpu_torch.core.device import on_card

KERNEL_MR = 12  # the one M * r the kernels are built for (AVT at rank 4)


def threshold(rate: float) -> int:
    """Keep where bits < this (32-bit; ``fused_dropout.py::_threshold``)."""
    return min(0xFFFFFFFF, int(round((1.0 - rate) * 4294967296.0)))


def _bits(key, bits, x2d: torch.Tensor) -> torch.Tensor:
    """The (N, d) 32-bit words as int64: forced, or drawn from the key."""
    if bits is not None:
        return bits.to(device=x2d.device, dtype=torch.int64)
    return key.bits32(tuple(x2d.shape), x2d.device)


def dropout_a_fwd_plain(x2d: torch.Tensor, a_flat: torch.Tensor, key,
                        rate: float, bits=None) -> torch.Tensor:
    """(N, M*r) fp32 = where(keep, x * (1/keep in x's dtype), 0) @ A."""
    keep = _bits(key, bits, x2d) < threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x2d.dtype)
    xd = torch.where(keep, x2d * scale, x2d.new_zeros(()))
    return xd.float() @ a_flat.float()


def dropout_a_bwd_plain(x2d: torch.Tensor, a_flat: torch.Tensor,
                        g: torch.Tensor, key, rate: float, bits=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dA in A's dtype) for the cotangent g (N, M*r)."""
    keep = _bits(key, bits, x2d) < threshold(rate)
    m = torch.where(keep, 1.0 / (1.0 - rate), 0.0)  # fp32
    g = g.float()
    dx = ((g @ a_flat.float().t()) * m).to(x2d.dtype)
    da = (x2d.float() * m).t() @ g
    return dx, da.to(a_flat.dtype)


# ----------------------------------------------------------- CUDA kernels

_lib = None


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        lib = kernels.library("fused_dropout")
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float)
        lib.moka_dropout_a_fwd.argtypes = [p, i, p, i, p, p, i, i, i, u, f,
                                           u, u, p]
        lib.moka_dropout_a_fwd.restype = i
        lib.moka_dropout_a_bwd.argtypes = [p, i, p, i, p, p, p, p, p, i, i,
                                           i, u, f, u, u, p]
        lib.moka_dropout_a_bwd.restype = i
        _lib = lib
    return _lib


def bwd_row_tiles(n: int) -> int:
    """Row tiles of the backward kernel (128 rows each): its dA workspace
    holds one (d, M*r) fp32 partial per tile."""
    return -(-n // 128)


def _kernel_inputs(x2d, a_flat, key, bits):
    """Check what the kernels take and return (x, A, bits or None, the
    two Philox key words)."""
    n, d = x2d.shape
    mr = a_flat.shape[1]
    if x2d.dtype not in (torch.bfloat16, torch.float32) or \
            a_flat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused dropout kernels take bf16 or fp32 x and A, "
                        f"not {x2d.dtype} and {a_flat.dtype}")
    if a_flat.shape[0] != d or a_flat.device != x2d.device:
        raise ValueError(f"A {tuple(a_flat.shape)} on {a_flat.device} for x "
                         f"{tuple(x2d.shape)} on {x2d.device}")
    if d % 4 or mr != KERNEL_MR:
        raise ValueError(f"fused dropout kernels need d % 4 == 0 and M*r "
                         f"{KERNEL_MR}, got d {d}, M*r {mr}")
    x2d, a_flat = x2d.contiguous(), a_flat.contiguous()
    if bits is not None:
        if tuple(bits.shape) != (n, d):
            raise ValueError(f"bits {tuple(bits.shape)} != x {(n, d)}")
        # the 32-bit words as the int32 with the same bit pattern
        b = bits.to(device=x2d.device, dtype=torch.int64)
        bits = torch.where(b >= 1 << 31, b - (1 << 32), b).to(
            torch.int32).contiguous()
        k0 = k1 = 0
    else:
        k0, k1 = key.philox_key
    if any(t.data_ptr() % 16 for t in (x2d, a_flat)) or \
            (bits is not None and bits.data_ptr() % 16):
        raise ValueError("fused dropout kernels need 16-byte aligned inputs")
    return x2d, a_flat, bits, k0, k1


def _launch_fwd(x2d, a_flat, key, rate, bits):
    from moka_tpu_torch import kernels
    x2d, a_flat, bits, k0, k1 = _kernel_inputs(x2d, a_flat, key, bits)
    n, d = x2d.shape
    mr = a_flat.shape[1]
    out = torch.empty((n, mr), dtype=torch.float32, device=x2d.device)
    x_scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=x2d.dtype))
    status = _library().moka_dropout_a_fwd(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), a_flat.data_ptr(),
        int(a_flat.dtype == torch.bfloat16),
        None if bits is None else bits.data_ptr(), out.data_ptr(), n, d, mr,
        threshold(rate), x_scale, k0, k1,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    kernels.check(status, "dropout_a_fwd")
    dropout_a_fwd.launches += 1
    return out


def _launch_bwd(x2d, a_flat, g, key, rate, bits):
    from moka_tpu_torch import kernels
    x2d, a_flat, bits, k0, k1 = _kernel_inputs(x2d, a_flat, key, bits)
    n, d = x2d.shape
    mr = a_flat.shape[1]
    if tuple(g.shape) != (n, mr):
        raise ValueError(f"g {tuple(g.shape)} != {(n, mr)}")
    g = g.to(device=x2d.device, dtype=torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=x2d.device)
    dx = torch.empty_like(x2d)
    work = torch.empty((bwd_row_tiles(n), d, mr), **f32)
    da = torch.empty((d, mr), **f32)
    status = _library().moka_dropout_a_bwd(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), a_flat.data_ptr(),
        int(a_flat.dtype == torch.bfloat16),
        None if bits is None else bits.data_ptr(), g.data_ptr(),
        dx.data_ptr(), work.data_ptr(), da.data_ptr(), n, d, mr,
        threshold(rate), 1.0 / (1.0 - rate), k0, k1,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    kernels.check(status, "dropout_a_bwd")
    dropout_a_bwd.launches += 1
    return dx, da.to(a_flat.dtype)


def dropout_a_fwd(x2d: torch.Tensor, a_flat: torch.Tensor, key, rate: float,
                  bits=None) -> torch.Tensor:
    """Kernel 6: (N, M*r) fp32 from x (N, d) and A (d, M*r); ``bits``
    (N, d) integers in [0, 2^32) replace the key's words."""
    if on_card(x2d, "fused dropout"):
        return _launch_fwd(x2d, a_flat, key, rate, bits)
    return dropout_a_fwd_plain(x2d, a_flat, key, rate, bits)


def dropout_a_bwd(x2d: torch.Tensor, a_flat: torch.Tensor, g: torch.Tensor,
                  key, rate: float, bits=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: (dx (N, d) in x's dtype, dA (d, M*r) in A's dtype) with
    the mask drawn again from the same key (or ``bits``)."""
    if on_card(x2d, "fused dropout"):
        return _launch_bwd(x2d, a_flat, g, key, rate, bits)
    return dropout_a_bwd_plain(x2d, a_flat, g, key, rate, bits)


# kernel launches (CUDA tensors only)
dropout_a_fwd.launches = 0
dropout_a_bwd.launches = 0


class _DropA(torch.autograd.Function):
    """Saves x and A (never the mask); the backward draws it again."""

    @staticmethod
    def forward(ctx, x2d, a_flat, key, bits, rate, plain):
        ctx.key, ctx.rate, ctx.plain = key, rate, plain
        ctx.save_for_backward(x2d, a_flat, bits)
        fwd = dropout_a_fwd_plain if plain else dropout_a_fwd
        return fwd(x2d, a_flat, key, rate, bits)

    @staticmethod
    def backward(ctx, g):
        x2d, a_flat, bits = ctx.saved_tensors
        bwd = dropout_a_bwd_plain if ctx.plain else dropout_a_bwd
        dx, da = bwd(x2d, a_flat, g, ctx.key, ctx.rate, bits)
        return dx, da, None, None, None, None


def _proj(x, lora_a, key, rate, bits, plain):
    b, L, d = x.shape
    m, _, r = lora_a.shape
    a_flat = lora_a.permute(1, 0, 2).reshape(d, m * r)
    out = _DropA.apply(x.reshape(b * L, d), a_flat, key, bits, float(rate),
                       plain)
    return out.reshape(b, L, m, r).permute(2, 0, 1, 3)


def dropout_a_proj(x: torch.Tensor, lora_a: torch.Tensor, key, rate: float,
                   *, _force_bits=None) -> torch.Tensor:
    """``einsum('bld,mdr->mblr', dropout(x), lora_a)`` as (M, b, L, r)
    fp32, differentiable in x and lora_a; the kernels on CUDA tensors.

    ``_force_bits``: tests only, (b*L, d) integers in [0, 2^32) used
    instead of the key's words (plain versions and kernels alike)."""
    return _proj(x, lora_a, key, rate, _force_bits, plain=False)


def dropout_a_proj_plain(x: torch.Tensor, lora_a: torch.Tensor, key,
                         rate: float, *, _force_bits=None) -> torch.Tensor:
    """``dropout_a_proj`` through the plain versions on any device: what
    the kernels compute, forward and backward, in plain torch."""
    return _proj(x, lora_a, key, rate, _force_bits, plain=True)
