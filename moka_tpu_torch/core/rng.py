"""Dropout keys with the shape of JAX's key API.

The JAX package splits one ``jax.random`` key per layer and folds in a
projection index, so every dropout mask is a pure function of the key's
path; its remat recompute therefore regenerates the same masks.  Torch has
no such keys: a ``torch.Generator`` carries state, and
``torch.utils.checkpoint`` restores the global RNG state for the recompute
but not an explicit generator's, so a recompute that drew from a shared
generator would get other masks and silently wrong gradients.

``DropoutKey`` keeps the JAX shape instead: ``split(n)`` and ``fold_in(i)``
derive new keys by hashing, and ``bits`` seeds fresh generators from the
key alone, a block of rows each (a sample and up to ``BITS_BLOCK``
positions), so the same key gives the same bits on every call, before and
after a checkpoint recompute, and a rank that holds some rows of the
array draws only the blocks those rows are in.  The bits are not JAX's
(threefry cannot be reproduced here); the parity tests pass a key whose
``bits`` come from ``jax.random`` along the same path.

``bits32`` serves the fused dropout (``ops.fused_dropout``): 32-bit words
of Philox4x32-10 under the key's 64-bit ``philox_key``, one word per
element of an (N, d) array, element (n, c) being word c % 4 of the block
at counter (n, c // 4, 0, 0).  The CUDA kernels (``kernels/csrc/
fused_dropout.cu``) draw the same words in the same layout, so the plain
version and the kernels drop the same elements, and the mask does not
depend on how a kernel tiles the array.  A key for one rank's rows of a
larger array (``rows``) gives its row counters as ``row_map``, which the
kernels and ``bits32`` take; a key for one rank's columns of it (``cols``:
the input of a row-parallel projection, split over the model axis) gives
its first column as ``col_start``, and element (n, c) of the rank's array
draws word (c0 + c) % 4 at counter (row, (c0 + c) // 4).
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

BITS_BLOCK = 1024  # positions (dim 1) of a sample that one generator draws


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
    ``bits32``.

    ``rows(dim, start, total)`` gives a key for one rank's rows of a
    larger array: an activation (b, L, d) that is rows [start, start +
    its size) of the whole along ``dim`` (the batch split over data
    parallel ranks: dim 0; the sequence split over a ring: dim 1).  Its
    ``bits``, and ``bits32`` at its ``row_map``, are those the whole array
    would draw, at this rank's rows, so a run split over ranks drops the
    elements one process drops; keys derived from it keep the view.

    ``cols(start, total)`` gives a key for columns [start, start + its
    width) of an array ``total`` wide in its last dim: its ``bits`` are
    the whole rows' values at those columns (drawn whole and narrowed) and
    its ``bits32`` those at ``col_start``.  The two views combine."""

    __slots__ = ("seed", "view", "col_view")

    def __init__(self, seed: int, view: tuple | None = None,
                 col_view: tuple | None = None):
        self.seed = int(seed) & _MASK63
        self.view = view
        self.col_view = col_view

    def split(self, n: int = 2) -> list["DropoutKey"]:
        return [DropoutKey(_derive(self.seed, 0, n, i), self.view,
                           self.col_view) for i in range(n)]

    def fold_in(self, i: int) -> "DropoutKey":
        return DropoutKey(_derive(self.seed, 1, i), self.view, self.col_view)

    def rows(self, dim: int, start: int, total: int) -> "DropoutKey":
        return DropoutKey(self.seed, (dim, start, total), self.col_view)

    def cols(self, start: int, total: int) -> "DropoutKey":
        return DropoutKey(self.seed, self.view, (start, total))

    @property
    def col_start(self) -> int:
        """The first column of this key's array in the whole one (0
        without a column view)."""
        return 0 if self.col_view is None else self.col_view[0]

    def bits(self, shape, device) -> torch.Tensor:
        """Uniform 16-bit values in [0, 65536) as int32 (torch compares no
        uint16).  An array (samples, positions, ...) is drawn a block at a
        time: sample i's positions [j, j + 1) * ``BITS_BLOCK`` from a
        generator seeded by this key, i and j alone.  With a view, the
        array is this rank's rows of the whole one: it draws only the
        blocks its rows are in, and gets the whole array's values there.
        With a column view the whole rows are drawn and narrowed."""
        shape = tuple(shape)
        if self.col_view is not None:
            start, total = self.col_view
            rows = DropoutKey(self.seed, self.view).bits(
                (*shape[:-1], total), device)
            return rows.narrow(-1, start, shape[-1]).contiguous()
        if len(shape) < 2:
            return self.bits((1, *shape), device).reshape(shape)
        n, length, rest = shape[0], shape[1], shape[2:]
        first_sample = first_pos = 0
        whole = length  # the whole array's positions
        if self.view is not None:
            dim, start, total = self.view
            if dim == 0:
                first_sample = start
            else:
                first_pos, whole = start, total
        out = torch.empty(shape, dtype=torch.int32, device=device)
        lo, hi = first_pos, first_pos + length
        g = torch.Generator(device=device)  # reseeded a block (a launch
        for i in range(n):                  # takes its state by value)
            for j in range(lo // BITS_BLOCK, -(-hi // BITS_BLOCK)):
                b0 = j * BITS_BLOCK
                b1 = min(b0 + BITS_BLOCK, whole)
                g.manual_seed(_derive(self.seed, 2, first_sample + i, j))
                a, b = max(lo, b0), min(hi, b1)
                dst = out[i, a - lo:b - lo]
                if (a, b) == (b0, b1):
                    dst.random_(0, 1 << 16, generator=g)
                else:  # the block's values as a whole draw gives them
                    block = torch.empty((b1 - b0, *rest), dtype=torch.int32,
                                        device=device)
                    block.random_(0, 1 << 16, generator=g)
                    dst.copy_(block[a - b0:b - b0])
        return out

    def row_map(self, shape3) -> tuple[int, int, int] | None:
        """With a view, where the rows of this rank's flattened (b, L, d)
        activation sit in the whole flattened (rows, d) array, as the
        fused-dropout kernels take it: (seg, stride, base), row n being
        base + n when seg is 0 (the batch split: a contiguous run), else
        (n // seg) * stride + base + n % seg (the sequence split: seg rows
        of each sample).  None without a view."""
        if self.view is None:
            return None
        _, L, _ = shape3
        dim, start, total = self.view
        if dim == 0:
            return 0, 0, start * L
        return L, total, start

    @property
    def philox_key(self) -> tuple[int, int]:
        """The 64-bit Philox key the fused-dropout kernels take, as (low,
        high) 32-bit words: the seed itself (already a hash)."""
        return self.seed & _MASK32, self.seed >> 32

    def bits32(self, shape, device, rows: tuple[int, int, int] | None = None,
               col0: int = 0) -> torch.Tensor:
        """Uniform 32-bit values in [0, 2^32) as int64 for an (N, d) array:
        element (n, c) is word (c0 + c) % 4 of Philox4x32-10 at counter
        (n, (c0 + c) // 4, 0, 0) under ``philox_key``, as the kernels draw
        it (``rows``: a ``row_map``, whose row of n is the counter's;
        ``col0``: the array's first column in the whole one)."""
        n, d = shape
        g0 = col0 // 4
        groups = -(-(col0 + d) // 4) - g0
        idx = torch.arange(n, device=device, dtype=torch.int64)
        if rows is not None:
            seg, stride, base = rows
            idx = idx + base if seg == 0 else \
                idx // seg * stride + base + idx % seg
        rows = idx[:, None]
        cols = g0 + torch.arange(groups, device=device,
                                 dtype=torch.int64)[None]
        rows, cols = torch.broadcast_tensors(rows, cols)
        zero = torch.zeros_like(rows)
        words = philox4x32((rows, cols, zero, zero), self.philox_key)
        first = col0 - 4 * g0
        return torch.stack(words, dim=-1).reshape(
            n, 4 * groups)[:, first:first + d]
