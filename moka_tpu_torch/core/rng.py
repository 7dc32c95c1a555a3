"""Dropout keys with the shape of JAX's key API.

The JAX package splits one ``jax.random`` key per layer and folds in a
projection index, so every dropout mask is a pure function of the key's
path; its remat recompute therefore regenerates the same masks.  Torch has
no such keys: a ``torch.Generator`` carries state, and
``torch.utils.checkpoint`` restores the global RNG state for the recompute
but not an explicit generator's, so a recompute that drew from a shared
generator would get other masks and silently wrong gradients.

``DropoutKey`` keeps the JAX shape instead: ``split(n)`` and ``fold_in(i)``
derive new keys by hashing, and ``bits`` seeds a fresh generator from the
key alone, so the same key gives the same bits on every call, before and
after a checkpoint recompute.  The bits are not JAX's (threefry cannot be
reproduced here); the parity tests pass a key whose ``bits`` come from
``jax.random`` along the same path.

``bits32`` serves the fused dropout (``ops.fused_dropout``): 32-bit words
of Philox4x32-10 under the key's 64-bit ``philox_key``, one word per
element of an (N, d) array, element (n, c) being word c % 4 of the block
at counter (n, c // 4, 0, 0).  The CUDA kernels (``kernels/csrc/
fused_dropout.cu``) draw the same words in the same layout, so the plain
version and the kernels drop the same elements, and the mask does not
depend on how a kernel tiles the array.
"""

from __future__ import annotations

import hashlib

import torch

_MASK63 = (1 << 63) - 1
_MASK32 = 0xFFFFFFFF

# Philox4x32-10 (Salmon et al., SC'11): round multipliers and key bumps
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_PHILOX_ROUNDS = 10


def _derive(seed: int, *parts: int) -> int:
    data = b"".join(int(p).to_bytes(8, "little", signed=True)
                    for p in (seed, *parts))
    digest = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(digest, "little") & _MASK63


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product m * b for b in
    [0, 2^32) held as int64: the product is formed from 16-bit halves of b
    so that no intermediate exceeds 2^49."""
    t = m * (b & 0xFFFF)
    u = m * (b >> 16)
    hi = (u + (t >> 16)) >> 16
    lo = (t + ((u & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32(counters: tuple[torch.Tensor, ...],
               key: tuple[int, int]) -> list[torch.Tensor]:
    """Philox4x32-10 of int64 counter words (each in [0, 2^32), any common
    shape) under a 2-word key: the four output words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = counters
    k0, k1 = key
    for r in range(_PHILOX_ROUNDS):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


class DropoutKey:
    """An immutable dropout key: ``split``, ``fold_in``, ``bits`` and
    ``bits32``."""

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = int(seed) & _MASK63

    def split(self, n: int = 2) -> list["DropoutKey"]:
        return [DropoutKey(_derive(self.seed, 0, n, i)) for i in range(n)]

    def fold_in(self, i: int) -> "DropoutKey":
        return DropoutKey(_derive(self.seed, 1, i))

    def bits(self, shape, device) -> torch.Tensor:
        """Uniform 16-bit values in [0, 65536) as int32 (torch compares no
        uint16), drawn from a generator seeded by this key alone."""
        g = torch.Generator(device=device).manual_seed(self.seed)
        return torch.randint(0, 1 << 16, tuple(shape), generator=g,
                             device=device, dtype=torch.int32)

    @property
    def philox_key(self) -> tuple[int, int]:
        """The 64-bit Philox key the fused-dropout kernels take, as (low,
        high) 32-bit words: the seed itself (already a hash)."""
        return self.seed & _MASK32, self.seed >> 32

    def bits32(self, shape, device) -> torch.Tensor:
        """Uniform 32-bit values in [0, 2^32) as int64 for an (N, d) array:
        element (n, c) is word c % 4 of Philox4x32-10 at counter
        (n, c // 4, 0, 0) under ``philox_key``, as the kernels draw it."""
        n, d = shape
        groups = -(-d // 4)
        rows = torch.arange(n, device=device, dtype=torch.int64)[:, None]
        cols = torch.arange(groups, device=device, dtype=torch.int64)[None]
        rows, cols = torch.broadcast_tensors(rows, cols)
        zero = torch.zeros_like(rows)
        words = philox4x32((rows, cols, zero, zero), self.philox_key)
        return torch.stack(words, dim=-1).reshape(n, 4 * groups)[:, :d]
