"""Block-diagonal products, BOFT's butterfly primitive (port of
``moka_tpu/ops/fbd.py``).

  * ``fast_block_diag``: (z, N, b, b) blocks -> the dense (z, N·b, N·b)
    block-diagonal matrix (API parity; its gradient is autograd's);
  * ``block_diag_matmul``: y[z] = blockdiag(blocks[z]) @ x[z] without
    forming the dense matrix.  With ``use_pallas`` (JAX's keyword and
    default) on a CUDA tensor that passes JAX's own gate (``b % 8 == 0``,
    ``m % 128 == 0``, not float64) it launches the hand-written kernel
    ``kernels/csrc/block_diag.cu`` (TPU kernel 10); otherwise, as JAX, the
    einsum with fp32 accumulation, cast to x's dtype.  The kernel path is
    forward only, as JAX's (its Pallas call has no VJP): a backward through
    it raises.  BOFT training takes ``use_pallas=False``, as in JAX;
  * ``butterfly_perm`` and ``cayley`` exactly as JAX's
    (``butterfly_perm(n, 1)`` is the identity).
"""

from __future__ import annotations

import ctypes

import torch

from moka_tpu_torch.core.device import on_card, raw_stream


def fast_block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(z, N, b, b) -> (z, N·b, N·b) dense block-diagonal."""
    z, n, b, _ = blocks.shape
    eye = torch.eye(n, dtype=blocks.dtype, device=blocks.device)
    out = torch.einsum("znxy,nm->znxmy", blocks, eye)
    return out.reshape(z, n * b, n * b)


def kernel_takes(b: int, m: int, dtype: torch.dtype) -> bool:
    """JAX's dispatch rule (``fbd.py:56``): the kernel for blocks of a
    multiple of 8 rows over columns in multiples of 128, not float64."""
    return b % 8 == 0 and m % 128 == 0 and dtype != torch.float64


def block_diag_matmul_plain(blocks: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
    """JAX's einsum: products summed in fp32 (or the wider input type),
    the result in x's dtype.  blocks (z, N, b, b), x (z, N·b, m)."""
    z, n, b, _ = blocks.shape
    m = x.shape[-1]
    acc = torch.promote_types(torch.promote_types(blocks.dtype, x.dtype),
                              torch.float32)
    y = torch.einsum("znab,znbm->znam", blocks.to(acc),
                     x.reshape(z, n, b, m).to(acc))
    return y.to(x.dtype).reshape(z, n * b, m)


MAX_BLOCK = 144  # the largest b whose blocks and two x stages fit a CTA's
                 # shared memory (kernels/csrc/block_diag.cu)
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ``moka_block_diag``'s argument and result types on ``lib`` (the
    built library, or an edited copy of its source built elsewhere) and
    return it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moka_block_diag.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.moka_block_diag.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from moka_tpu_torch import kernels
        _lib = bind(kernels.library("block_diag"))
    return _lib


def _launch(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Kernel 10 on the card: checks what it takes (fp32 blocks, bf16 or
    fp32 x, JAX's gate, b <= MAX_BLOCK, one device, 16-byte aligned) and
    raises otherwise."""
    z, n, b, b2 = blocks.shape
    if b != b2 or x.dim() != 3 or tuple(x.shape[:2]) != (z, n * b):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not tile x "
                         f"{tuple(x.shape)}")
    m = x.shape[-1]
    if blocks.dtype != torch.float32:
        raise TypeError(f"block_diag kernel takes fp32 blocks, not "
                        f"{blocks.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"block_diag kernel takes bf16 or fp32 x, not "
                        f"{x.dtype}")
    if not kernel_takes(b, m, x.dtype) or b > MAX_BLOCK:
        raise ValueError(f"block_diag kernel needs b % 8 == 0, b <= "
                         f"{MAX_BLOCK} and m % 128 == 0, not b {b} m {m}")
    if blocks.device != x.device:
        raise ValueError(f"blocks on {blocks.device}, x on {x.device}")
    blocks, x = blocks.contiguous(), x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("block_diag kernel needs a 16-byte aligned x")
    y = torch.empty_like(x)
    status = _library().moka_block_diag(
        blocks.data_ptr(), x.data_ptr(), y.data_ptr(), z, n, b, m,
        int(x.dtype == torch.bfloat16), raw_stream(x.device))
    if status:
        from moka_tpu_torch import kernels
        kernels.check(status, "block_diag")
    block_diag_matmul.launches += 1
    return y


class _KernelProduct(torch.autograd.Function):
    """The kernel path: forward only, as JAX's Pallas call."""

    @staticmethod
    def forward(ctx, blocks, x):
        return _launch(blocks, x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "block_diag_matmul(use_pallas=True) has no backward (nor has "
            "JAX's kernel path): differentiate with use_pallas=False")


def block_diag_matmul(blocks: torch.Tensor, x: torch.Tensor,
                      use_pallas: bool = True) -> torch.Tensor:
    """y[z] = blockdiag(blocks[z]) @ x[z]; blocks (z, N, b, b), x
    (z, N·b, m) -> (z, N·b, m) in x's dtype.  Kernel 10 for a CUDA x under
    ``use_pallas`` and JAX's gate (``kernel_takes``), the einsum
    otherwise; a CPU x runs the plain version."""
    b, m = blocks.shape[-1], x.shape[-1]
    if use_pallas and kernel_takes(b, m, x.dtype) and \
            on_card(x, "block-diagonal product"):
        return _KernelProduct.apply(blocks, x)
    return block_diag_matmul_plain(blocks, x)


block_diag_matmul.launches = 0  # kernel launches (CUDA tensors only)


def butterfly_perm(n: int, stride: int, device=None) -> torch.Tensor:
    """BOFT's butterfly permutation between factors: within each group of
    2·stride indices, interleave the two halves."""
    idx = torch.arange(n, device=device)
    group = idx // (2 * stride)
    within = idx % (2 * stride)
    half = torch.where(within < stride, within * 2,
                       (within - stride) * 2 + 1)
    return group * (2 * stride) + half


def cayley(q: torch.Tensor) -> torch.Tensor:
    """Skew-symmetrise and take the Cayley transform, batched:
    R = (I - S)^-1 (I + S) with S = (Q - Q^T)/2, an orthogonal block."""
    s = 0.5 * (q - q.transpose(-1, -2))
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return torch.linalg.solve(eye - s, eye + s)
