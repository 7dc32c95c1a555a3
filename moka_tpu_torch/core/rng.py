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
"""

from __future__ import annotations

import hashlib

import torch

_MASK63 = (1 << 63) - 1


def _derive(seed: int, *parts: int) -> int:
    data = b"".join(int(p).to_bytes(8, "little", signed=True)
                    for p in (seed, *parts))
    digest = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(digest, "little") & _MASK63


class DropoutKey:
    """An immutable dropout key: ``split``, ``fold_in`` and ``bits``."""

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
