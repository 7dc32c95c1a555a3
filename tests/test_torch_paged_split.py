"""The decode kernel's split of the keys into spans and their merge, on the
CPU (``moka_tpu_torch/ops/paged_decode.py``): ``plan_spans`` covers every
key below ``length`` once, in order, and sizes the grid by the card; the
plain split-and-merge (``paged_decode_split_plain``, the kernel's base-2
arithmetic per span, merged in span order) against JAX's block loop
(``moka_tpu.ops.paged_decode.paged_decode_attention``) at ``tiny()``'s
head_dim on bf16-valued and int8 caches."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moka_tpu.models import llama as jllama
from moka_tpu.ops.paged_decode import paged_decode_attention as jpaged
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.ops.paged_decode import (CTAS_PER_SM, TILE_KEYS,
                                             paged_decode_split_plain,
                                             plan_spans, span_ranges)

H100_SMS = 132
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)  # fp32 on both sides; exp against
                                        # exp2 and the sums' order differ


def _covers(ranges, length):
    """Every key below ``length`` once, in order, in whole tiles."""
    assert ranges[0][0] == 0 and ranges[-1][1] == length
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    for a, b in ranges:
        assert a < b <= length and a % TILE_KEYS == 0
        assert b == length or b % TILE_KEYS == 0


@pytest.mark.parametrize("B,K,length,spans", [
    (8, 32, 928, 1),      # the 7B serving shape: one span a pair, no merge
    (8, 32, 1025, 1),     # infer's cache: the one-key tail ends the span
    (1, 32, 3000, 8),     # one sample: several spans
    (4, 8, 700, 6),       # llama2_70b heads, GQA 64:8
    (2, 32, 200, 4),      # one 256-key chunk of the first kernel
    (1, 1, 1, 1),         # one key
    (1, 1, 65, 2),        # a one-key tail tile
])
def test_plan_at_the_checked_shapes(B, K, length, spans):
    ranges = span_ranges(B, K, length, H100_SMS)
    assert len(ranges) == spans == plan_spans(B, K, length, H100_SMS)[1]
    _covers(ranges, length)


def test_plan_covers_every_key_once_and_fills_about_a_wave():
    """Over a grid of shapes and SM counts: the spans cover [0, length) in
    order, in whole tiles, none empty and none past ``length``; the grid
    holds at most one wave of CTAS_PER_SM CTAs an SM unless B * K alone
    exceeds it, and at least half a wave where the keys allow."""
    for sms in (132, 114, 78, 1):
        for B in (1, 2, 3, 8, 16):
            for K in (1, 8, 32):
                for length in (1, 63, 64, 65, 200, 928, 1025, 3000, 4096):
                    per, n = plan_spans(B, K, length, sms)
                    tiles = -(-length // TILE_KEYS)
                    ranges = span_ranges(B, K, length, sms)
                    assert len(ranges) == n
                    _covers(ranges, length)
                    wave = sms * CTAS_PER_SM
                    assert n == 1 or B * K * n <= wave
                    assert n == tiles or 2 * B * K * n >= min(wave, B * K *
                                                               tiles)


def _case(H, K, quantized, seed, S=256, N=2, B=4, length=193):
    """q and a (N, B, S, K, hd) cache at tiny()'s head_dim, bf16-valued in
    fp32 or int8 (JAX's codes and scales), its cells at and past
    ``length`` poisoned; row 0 masked on its first 70 keys (its first tile
    sees no key), row 1 on its first 3, row 2 on every key, row 3 not at
    all."""
    hd = LlamaConfig.tiny().dim // LlamaConfig.tiny().n_heads
    rng = np.random.default_rng(seed)

    def bf16(x):
        return torch.from_numpy(x).bfloat16().float().numpy()

    q = bf16(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    ck = bf16(rng.standard_normal((N, B, S, K, hd)).astype(np.float32))
    cv = bf16(rng.standard_normal((N, B, S, K, hd)).astype(np.float32))
    ck[:, :, length:] = 1e6
    cv[:, :, length:] = -1e6
    mask = np.ones((B, S), np.int32)
    mask[0, :70] = 0
    mask[1, :3] = 0
    mask[2] = 0
    if not quantized:
        return q, ck, cv, mask
    kq, ks = jllama._kv_quantize(jnp.asarray(ck))
    vq, vs = jllama._kv_quantize(jnp.asarray(cv))
    return q, {"q": np.asarray(kq), "s": np.asarray(ks)}, \
        {"q": np.asarray(vq), "s": np.asarray(vs)}, mask


def _side(x, conv):
    if isinstance(x, dict):
        return {k: conv(np.array(v)) for k, v in x.items()}
    return conv(x)


SPANS = {  # name: spans of keys below 193
    "the plan's four tiles on 16 SMs, a one-key tail span":
        span_ranges(4, 2, 193, 16),
    "one span": [(0, 193)],
    "uneven spans, the first seen by no key of row 0": [(0, 64), (64, 192),
                                                        (192, 193)]}


@pytest.mark.parametrize("spans", list(SPANS))
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("H,K", [(2, 2), (4, 2), (16, 2)])  # G 1, 2, 8
def test_split_merge_matches_jax(H, K, quantized, spans):
    """The split-and-merge against JAX's loop on the rows that see a key,
    within 1e-5 relative in fp32; the row that sees no key reads 0 (JAX's
    loop gives it the mean of the values it walked)."""
    q, ck, cv, mask = _case(H, K, quantized, seed=H + 10 * quantized)
    length, layer = 193, 1
    want = np.asarray(jpaged(jnp.asarray(q), _side(ck, jnp.asarray),
                             _side(cv, jnp.asarray), jnp.asarray(mask),
                             layer, length))
    got = paged_decode_split_plain(
        torch.from_numpy(q), _side(ck, torch.from_numpy),
        _side(cv, torch.from_numpy), torch.from_numpy(mask), layer, length,
        SPANS[spans])
    rows = [0, 1, 3]
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **SPLIT_TOL)
    assert not got[2].any() and torch.isfinite(got).all()


def test_plan_of_the_tests_has_a_one_key_tail():
    """The planned case above: four one-tile spans, the last holding one
    key."""
    assert SPANS["the plan's four tiles on 16 SMs, a one-key tail span"] == [
        (0, 64), (64, 128), (128, 192), (192, 193)]
