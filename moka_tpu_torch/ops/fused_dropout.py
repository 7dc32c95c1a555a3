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
plain torch.  The kernels take every M*r (any rank with any number of
modalities) and d a multiple of 8 (``fused_dropout_supported``); the plain
versions take any shape.  ``with_fused_dropout()`` is an explicit opt-in:
on the card a width the kernels do not take raises, and nothing falls back
to the unfused dropout, which draws other masks.

The bits: 32-bit words compared with ``threshold(rate)``, as the JAX kernel
compares them.  Element (n, c) of the (N, d) input takes word c % 4 of
Philox4x32-10 at counter (n, c // 4) under the key's ``philox_key``
(``core.rng.DropoutKey.bits32`` computes the same words in plain torch), so
the mask depends on the key alone: the forward, its remat recompute and the
backward drop the same elements whatever the tiling.  A key for one rank's
rows of a larger array (``DropoutKey.rows``: the batch or the sequence
split over ranks) hands the kernels its ``row_map``, and row n draws at the
larger array's row, so the ranks drop what one process drops; a key for
one rank's columns (``DropoutKey.cols``: the input of a row-parallel
projection under tensor parallelism) hands them its ``col_start`` c0, and
column c draws at counter (row, (c0 + c) // 4), word (c0 + c) % 4 (the
kernels take c0 a multiple of 4, as every shipped width's split gives:
4096/m, 11008/m and 22016/m for m in 2, 4, 8).  The TPU
kernel seeds its generator per row block instead, and JAX's interpret mode
(the CPU) draws ``jax.random.bits(key, (N, d), uint32)``; the parity tests
hand the port those words through the key's ``bits32``, or through
``_force_bits``, which both the plain versions and the kernels take.

Numerics, as the JAX kernels: forward ``x_d = where(keep, x * (1/keep
rounded to x's dtype), 0)`` in x's dtype, then the product in fp32;
backward ``m = where(keep, 1/keep in fp32, 0)``, ``dx = ((g @ A^T) *
m)`` in x's dtype and ``dA = (x * m)^T @ g`` in fp32, cast to A's dtype.
The plain backward forms g @ A^T as one fp32 chain over the M*r columns
in order, the chain kernel 7 runs, so that dx is the same to the bit.
"""

from __future__ import annotations

import ctypes

import torch

from moka_tpu_torch.core.device import on_card, raw_stream

def fused_dropout_supported(mr: int, d: int) -> bool:
    """Whether kernels 6-7 take an adapter of M*r ``mr`` on rows of width
    ``d``: any M*r of at least 1 (past 64 the kernels loop over its 64-row
    tiles) and d a multiple of 8 (the TMA rows' 16-byte strides).  The
    wrappers raise on anything else on the card."""
    return mr >= 1 and d > 0 and d % 8 == 0


def threshold(rate: float) -> int:
    """Keep where bits < this (32-bit; ``fused_dropout.py::_threshold``)."""
    return min(0xFFFFFFFF, int(round((1.0 - rate) * 4294967296.0)))


def _bits(key, bits, x2d: torch.Tensor, rows=None, col0: int = 0
          ) -> torch.Tensor:
    """The (N, d) 32-bit words as int64: forced, or drawn from the key
    (at the counter rows of ``rows``, a ``DropoutKey.row_map``, and the
    columns from ``col0`` on)."""
    if bits is not None:
        return bits.to(device=x2d.device, dtype=torch.int64)
    if rows is None and not col0:  # (also the parity tests' JAX key)
        return key.bits32(tuple(x2d.shape), x2d.device)
    return key.bits32(tuple(x2d.shape), x2d.device, rows=rows, col0=col0)


def dropout_a_fwd_plain(x2d: torch.Tensor, a_flat: torch.Tensor, key,
                        rate: float, bits=None, rows=None,
                        col0: int = 0) -> torch.Tensor:
    """(N, M*r) fp32 = where(keep, x * (1/keep in x's dtype), 0) @ A."""
    keep = _bits(key, bits, x2d, rows, col0) < threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x2d.dtype)
    xd = torch.where(keep, x2d * scale, x2d.new_zeros(()))
    return xd.float() @ a_flat.float()


def dropout_a_bwd_plain(x2d: torch.Tensor, a_flat: torch.Tensor,
                        g: torch.Tensor, key, rate: float, bits=None,
                        rows=None, col0: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dA in A's dtype) for the cotangent g (N, M*r)."""
    keep = _bits(key, bits, x2d, rows, col0) < threshold(rate)
    m = torch.where(keep, 1.0 / (1.0 - rate), 0.0)  # fp32
    g = g.float()
    # g A^T as one fp32 chain over j = 0 .. M*r - 1, the order kernel 7's
    # dx takes (on the card each addcmul_ is a fused multiply-add): a
    # library product may split the sum over j (cuBLAS does at N 333, d
    # 200, M*r 256), which moves the rounding of dx
    at = a_flat.float().t()
    prod = g.new_zeros((x2d.shape[0], at.shape[1]))
    for j in range(at.shape[0]):
        prod.addcmul_(g[:, j:j + 1], at[j])
    dx = (prod * m).to(x2d.dtype)
    da = (x2d.float() * m).t() @ g
    return dx, da.to(a_flat.dtype)


# ----------------------------------------------------------- CUDA kernels

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (fused_dropout.cu built, or an edited copy of it) with its
    entry points' argument types set."""
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
    lib.moka_dropout_a_fwd.argtypes = [p, i, p, i, p, p, p, i, i, i, u, f, u,
                                       u, u, u, u, u, p]
    lib.moka_dropout_a_fwd.restype = i
    lib.moka_dropout_fwd_workspace.argtypes = [i, i, i]
    lib.moka_dropout_fwd_workspace.restype = ctypes.c_long
    lib.moka_dropout_a_bwd.argtypes = [p, i, p, i, p, p, p, p, i, i, i, u, f,
                                       u, u, u, u, u, u, p]
    lib.moka_dropout_a_bwd.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        _lib = bind(kernels.library("fused_dropout"))
    return _lib


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
    if not fused_dropout_supported(mr, d):
        raise ValueError(f"fused dropout kernels take M*r >= 1 and d % 8 "
                         f"== 0, got M*r {mr}, d {d}")
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


def _counters(x2d, rows, col0: int, forced: bool
              ) -> tuple[int, int, int, int]:
    """The kernels' (seg, stride, base) for ``rows`` (a
    ``DropoutKey.row_map`` or None: the array itself; forced words have
    no counters), checked to keep every row's counter in 32 bits, and the
    column counter of x's first column, ``col0 // 4`` (``col0`` a multiple
    of 4: the kernels add it to the counter of a group of four columns)."""
    if forced:
        return 0, 0, 0, 0
    if col0 % 4 or col0 < 0:
        raise ValueError(f"fused dropout kernels take a column offset that "
                         f"is a multiple of 4, not {col0}")
    if (col0 + x2d.shape[1]) // 4 >= 1 << 32:
        raise ValueError(f"columns from {col0} leave the 32-bit counter")
    if rows is None:
        return 0, 0, 0, col0 // 4
    n = x2d.shape[0]
    seg, stride, base = rows
    last = n - 1 + base if seg == 0 else \
        (n - 1) // seg * stride + base + (n - 1) % seg
    if last >= 1 << 32:
        raise ValueError(f"row map {rows}: row {last} of {n} rows leaves "
                         f"the 32-bit Philox counter")
    return seg, stride, base, col0 // 4


def _launch_fwd(x2d, a_flat, key, rate, bits, rows, col0):
    from moka_tpu_torch import kernels
    x2d, a_flat, bits, k0, k1 = _kernel_inputs(x2d, a_flat, key, bits)
    keys = (k0, k1, *_counters(x2d, rows, col0, bits is not None))
    n, d = x2d.shape
    mr = a_flat.shape[1]
    lib = _library()
    x_bf16, a_bf16 = (int(t.dtype == torch.bfloat16) for t in (x2d, a_flat))
    out = torch.empty((n, mr), dtype=torch.float32, device=x2d.device)
    # bf16 x: A's transposed bf16 parts, written by the kernel's first pass
    work = torch.empty(lib.moka_dropout_fwd_workspace(d, mr, a_bf16)
                       if x_bf16 else 0, dtype=torch.uint8, device=x2d.device)
    x_scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=x2d.dtype))
    status = lib.moka_dropout_a_fwd(
        x2d.data_ptr(), x_bf16, a_flat.data_ptr(), a_bf16,
        None if bits is None else bits.data_ptr(), out.data_ptr(),
        work.data_ptr(), n, d, mr, threshold(rate), x_scale, *keys,
        raw_stream(x2d.device))
    kernels.check(status, "dropout_a_fwd")
    dropout_a_fwd.launches += 1
    dropout_a_fwd.offset_launches += int(keys[-1] > 0)
    return out


def _launch_bwd(x2d, a_flat, g, key, rate, bits, rows, col0):
    from moka_tpu_torch import kernels
    x2d, a_flat, bits, k0, k1 = _kernel_inputs(x2d, a_flat, key, bits)
    keys = (k0, k1, *_counters(x2d, rows, col0, bits is not None))
    n, d = x2d.shape
    mr = a_flat.shape[1]
    if tuple(g.shape) != (n, mr):
        raise ValueError(f"g {tuple(g.shape)} != {(n, mr)}")
    # g's rows padded with zero columns to a multiple of 4 (the kernels'
    # 16-byte TMA rows; their sums stop at M*r)
    g = g.to(device=x2d.device, dtype=torch.float32)
    if mr % 4:
        g = torch.nn.functional.pad(g, (0, -mr % 4))
    g = g.contiguous()
    if g.data_ptr() % 16:
        raise ValueError("fused dropout kernels need 16-byte aligned inputs")
    dx = torch.empty_like(x2d)
    da = torch.empty_like(a_flat)  # in A's dtype, written by the kernel
    status = _library().moka_dropout_a_bwd(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), a_flat.data_ptr(),
        int(a_flat.dtype == torch.bfloat16),
        None if bits is None else bits.data_ptr(), g.data_ptr(),
        dx.data_ptr(), da.data_ptr(), n, d, mr, threshold(rate),
        1.0 / (1.0 - rate), *keys, raw_stream(x2d.device))
    kernels.check(status, "dropout_a_bwd")
    dropout_a_bwd.launches += 1
    dropout_a_bwd.offset_launches += int(keys[-1] > 0)
    return dx, da


def dropout_a_fwd(x2d: torch.Tensor, a_flat: torch.Tensor, key, rate: float,
                  bits=None, rows=None, col0: int = 0) -> torch.Tensor:
    """Kernel 6: (N, M*r) fp32 from x (N, d) and A (d, M*r); ``bits``
    (N, d) integers in [0, 2^32) replace the key's words; ``rows`` (a
    ``DropoutKey.row_map``) places x's rows in a larger array and ``col0``
    its columns (a ``DropoutKey.col_start``)."""
    if on_card(x2d, "fused dropout"):
        return _launch_fwd(x2d, a_flat, key, rate, bits, rows, col0)
    return dropout_a_fwd_plain(x2d, a_flat, key, rate, bits, rows, col0)


def dropout_a_bwd(x2d: torch.Tensor, a_flat: torch.Tensor, g: torch.Tensor,
                  key, rate: float, bits=None, rows=None, col0: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: (dx (N, d) in x's dtype, dA (d, M*r) in A's dtype) with
    the mask drawn again from the same key (or ``bits``), rows and
    columns."""
    if on_card(x2d, "fused dropout"):
        return _launch_bwd(x2d, a_flat, g, key, rate, bits, rows, col0)
    return dropout_a_bwd_plain(x2d, a_flat, g, key, rate, bits, rows, col0)


# kernel launches (CUDA tensors only); ``offset_launches``: those at a
# column offset above 0 (a row-parallel projection's columns)
dropout_a_fwd.launches = 0
dropout_a_bwd.launches = 0
dropout_a_fwd.offset_launches = 0
dropout_a_bwd.offset_launches = 0


class _DropA(torch.autograd.Function):
    """Saves x and A (never the mask); the backward draws it again."""

    @staticmethod
    def forward(ctx, x2d, a_flat, key, bits, rows, col0, rate, plain):
        ctx.key, ctx.rows, ctx.col0 = key, rows, col0
        ctx.rate, ctx.plain = rate, plain
        ctx.save_for_backward(x2d, a_flat, bits)
        fwd = dropout_a_fwd_plain if plain else dropout_a_fwd
        return fwd(x2d, a_flat, key, rate, bits, rows, col0)

    @staticmethod
    def backward(ctx, g):
        x2d, a_flat, bits = ctx.saved_tensors
        bwd = dropout_a_bwd_plain if ctx.plain else dropout_a_bwd
        dx, da = bwd(x2d, a_flat, g, ctx.key, ctx.rate, bits, ctx.rows,
                     ctx.col0)
        return dx, da, None, None, None, None, None, None


def _proj(x, lora_a, key, rate, bits, plain):
    b, L, d = x.shape
    m, _, r = lora_a.shape
    # one rank's rows (or columns) of a split array: where they sit in the
    # whole one
    rows = key.row_map(x.shape) if hasattr(key, "row_map") else None
    col0 = getattr(key, "col_start", 0)
    a_flat = lora_a.permute(1, 0, 2).reshape(d, m * r)
    out = _DropA.apply(x.reshape(b * L, d), a_flat, key, bits, rows, col0,
                       float(rate), plain)
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
