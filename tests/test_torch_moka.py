"""Port parity: ``moka_tpu_torch.ops.moka`` and ``ops.moka_pallas`` against
the JAX package on the CPU, fp32, same numpy inputs on both sides.

Tolerances: both sides compute in fp32 with different summation orders
(XLA vs torch/MKL), so 1e-5 relative + absolute; the fused JAX kernel runs
in Pallas interpret mode as its own tests run it.  LoRA dropout: the port
is given the 16-bit values ``jax.random.bits`` draws for the same key
(``JaxKey``), so both sides drop the same elements."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.ops import moka as jm
from moka_tpu.ops.moka_pallas import moka_delta_fused as j_fused
from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.ops import moka as tm
from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                            moka_delta_fused_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _specs(flavour, window=None):
    if flavour == "avt":
        args = dict(rank=4, lora_alpha=16.0, blc_weight=0.7, dropout_rate=0.0)
        js, ts = jm.MokaSpec.avt(**args), tm.MokaSpec.avt(**args)
    else:
        args = dict(rank=4, attn_weight=0.05, dropout_rate=0.0)
        js, ts = jm.MokaSpec.vt(**args), tm.MokaSpec.vt(**args)
    if window is not None:
        js, ts = js.with_question_window(window), ts.with_question_window(
            window)
    return js, ts


def _inputs(seed, b, L, d_in, d_out, M, no_question_row=True):
    """Disjoint modality masks, a contiguous question span inside the text
    part, and (optionally) a last row with no question token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, d_in)).astype(np.float32)
    a = (rng.standard_normal((M, d_in, 4)) * 0.2).astype(np.float32)
    bm = (rng.standard_normal((4, d_out)) * 0.2).astype(np.float32)
    mod = np.zeros((M, b, L), np.float32)
    q = np.zeros((b, L), np.float32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(2, L - 1), M - 1, replace=False))
        bounds = [0, *cuts, L]
        for m in range(M):
            mod[m, i, bounds[m]:bounds[m + 1]] = 1
        text_end = bounds[1]
        s = int(rng.integers(0, max(1, text_end - 1)))
        q[i, s:min(text_end, s + 3)] = 1
    if no_question_row:
        q[-1] = 0
    return x, a, bm, mod, q


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("flavour", ["avt", "vt"])
@pytest.mark.parametrize("window", [None, 4])
def test_moka_delta_matches_jax(flavour, window):
    js, ts = _specs(flavour, window)
    x, a, bm, mod, q = _inputs(0, 3, 13, 16, 12, js.num_modalities)
    want = jm.moka_delta(*map(jnp.asarray, (x, a, bm, mod, q)), js)
    got = tm.moka_delta(*_t(x, a, bm, mod, q), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moka_delta_no_question_rows_skip_attention():
    """A row without question tokens gets no attention term: its delta
    equals the delta of the same row with attn_weight 0."""
    js, ts = _specs("avt")
    x, a, bm, mod, q = _inputs(1, 2, 10, 8, 8, 3)
    got = tm.moka_delta(*_t(x, a, bm, mod, q), ts)
    import dataclasses
    no_attn = dataclasses.replace(ts, attn_weight=0.0)
    plain = tm.moka_delta(*_t(x, a, bm, mod, q), no_attn)
    np.testing.assert_allclose(got[-1].numpy(), plain[-1].numpy(), **TOL)
    assert not np.allclose(got[0].numpy(), plain[0].numpy())


def test_moka_delta_bf16_input_matches_jax():
    """bf16 activations with fp32 adapters (the serving dtypes): the delta
    is computed in fp32 and rounded once to bf16 on both sides."""
    js, ts = _specs("avt")
    x, a, bm, mod, q = _inputs(2, 2, 12, 16, 8, 3)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jm.moka_delta(xj, *map(jnp.asarray, (a, bm, mod, q)), js)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = tm.moka_delta(xt, *_t(a, bm, mod, q), ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)  # one bf16 ulp


def test_lora_delta_and_moka_linear_match_jax():
    js, ts = _specs("vt")
    x, a, bm, _, _ = _inputs(3, 2, 5, 16, 12, 2)
    want = jm.lora_delta(jnp.asarray(x), jnp.asarray(a[0]), jnp.asarray(bm),
                         jm.decode_scale(js))
    got = tm.lora_delta(*_t(x, a[0], bm), tm.decode_scale(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w = np.random.default_rng(3).standard_normal((16, 12)).astype(np.float32)
    want = jm.moka_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                          jnp.asarray(bm), None, None, js)
    got = tm.moka_linear(*_t(x, w, a, bm), None, None, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tm.decode_scale(ts) == jm.decode_scale(js)


@pytest.mark.parametrize("kq", [3, 6, 40])
def test_question_window_matches_jax(kq):
    rng = np.random.default_rng(4)
    keys = rng.standard_normal((3, 12, 4)).astype(np.float32)
    q = np.zeros((3, 12), np.float32)
    q[0, 2:5] = 1
    q[1, 9:12] = 1   # window clamped at the end
    kw_j, mw_j = jm.question_window(jnp.asarray(keys), jnp.asarray(q), kq)
    kw_t, mw_t = tm.question_window(*_t(keys, q), kq)
    np.testing.assert_array_equal(kw_t.numpy(), np.asarray(kw_j))
    np.testing.assert_array_equal(mw_t.numpy(), np.asarray(mw_j))


def test_rank_space_cross_attention_matches_jax():
    rng = np.random.default_rng(5)
    qv = rng.standard_normal((2, 9, 4)).astype(np.float32)
    keys = rng.standard_normal((2, 9, 4)).astype(np.float32)
    qm = np.zeros((2, 9), np.float32)
    qm[0, 1:4] = 1  # row 1 has no question: zero attention
    want = jm.rank_space_cross_attention(*map(jnp.asarray, (qv, keys, qm)),
                                         dk=4)
    got = tm.rank_space_cross_attention(*_t(qv, keys, qm), dk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got[1].numpy() == 0)


def test_init_moka_params_and_unported_paths():
    ts = tm.MokaSpec.avt(rank=4)
    g = torch.Generator().manual_seed(0)
    p = tm.init_moka_params(g, 16, 8, ts, device="cpu")
    assert p["a"].shape == (3, 16, 4) and p["b"].shape == (4, 8)
    assert float(p["a"].abs().max()) <= 0.25 and not p["b"].any()
    x, a, bm, mod, q = _inputs(6, 1, 6, 16, 8, 3)
    fused = tm.moka_delta(*_t(x, a, bm, mod, q), ts.with_fused_dropout(),
                          dropout_rng=DropoutKey(0))  # ported: runs
    assert fused.shape == (1, 6, 8) and torch.isfinite(fused).all()
    flash = tm.moka_delta(*_t(x, a, bm, mod, q),
                          tm.MokaSpec.avt(dropout_rate=0.0)
                          .with_flash_rank_attn())  # ported: runs
    plain = tm.moka_delta(*_t(x, a, bm, mod, q),
                          tm.MokaSpec.avt(dropout_rate=0.0))
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("flavour,L", [("avt", 24), ("vt", 24), ("avt", 21)])
def test_fused_plain_matches_jax_interpret_kernel(flavour, L):
    """The fused delta's plain version against the Pallas kernel in
    interpret mode (block 8; L=21 leaves a ragged last block)."""
    js, ts = _specs(flavour)
    x, a, bm, mod, q = _inputs(7, 2, L, 16, 12, js.num_modalities)
    want = j_fused(*map(jnp.asarray, (x, a, bm, mod, q)), js, 8, True)
    got = moka_delta_fused(*_t(x, a, bm, mod, q), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = moka_delta_fused_plain(*_t(x, a, bm, mod, q), ts)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0, atol=0)
    assert moka_delta_fused.launches == 0  # CPU tensors never launch


def test_fused_grads_match_jax():
    """Backward of the autograd.Function (autograd through the plain
    moka_delta) against jax.grad through the JAX custom VJP."""
    js, ts = _specs("avt")
    x, a, bm, mod, q = _inputs(8, 2, 16, 12, 12, 3)
    w = np.random.default_rng(8).standard_normal((2, 16, 12)).astype(
        np.float32)

    def jloss(x_, a_, b_):
        out = j_fused(x_, a_, b_, jnp.asarray(mod), jnp.asarray(q), js, 8,
                      True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, a, bm)))
    xt, at, bt = (t.requires_grad_(True) for t in _t(x, a, bm))
    out = moka_delta_fused(xt, at, bt, *_t(mod, q), ts)
    (out * torch.from_numpy(w)).sum().backward()
    for g_t, g_j in zip((xt.grad, at.grad, bt.grad), want):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                                   atol=1e-5)


class JaxKey:
    """``DropoutKey``'s interface over a ``jax.random`` key."""

    def __init__(self, key):
        self.key = key

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def bits(self, shape, device):
        bits = jax.random.bits(self.key, tuple(shape), jnp.uint16)
        return torch.from_numpy(np.asarray(bits).astype(np.int32)).to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_lora_dropout_matches_jax(dtype, rate):
    """Same bits, same kept elements, same 1/keep scaling in x's dtype:
    bit-exact."""
    x = np.random.default_rng(10).standard_normal((3, 7, 16)).astype(
        np.float32)
    key = jax.random.key(4)
    want = jm.lora_dropout(jnp.asarray(x, dtype), key, rate)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tm.lora_dropout(xt, JaxKey(key), rate)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("flavour,bf16_dots", [("avt", False), ("vt", False),
                                               ("avt", True)])
def test_moka_delta_with_dropout_matches_jax(flavour, bf16_dots):
    """Dropout on the adapter input: the delta and its gradients in x, A
    and B (with bf16_dots the dropout applies to the bf16-rounded x, as in
    JAX)."""
    js, ts = _specs(flavour, window=4)
    js = dataclasses.replace(js, dropout_rate=0.1)
    ts = dataclasses.replace(ts, dropout_rate=0.1)
    if bf16_dots:
        js, ts = js.with_bf16_dots(), ts.with_bf16_dots()
    x, a, bm, mod, q = _inputs(11, 2, 12, 16, 8, js.num_modalities)
    w = np.random.default_rng(11).standard_normal((2, 12, 8)).astype(
        np.float32)
    key = jax.random.key(5)

    def jloss(x_, a_, b_):
        out = jm.moka_delta(x_, a_, b_, jnp.asarray(mod), jnp.asarray(q), js,
                            dropout_rng=key)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *map(jnp.asarray, (x, a, bm)))
    xt, at, bt = (t.requires_grad_(True) for t in _t(x, a, bm))
    got = tm.moka_delta(xt, at, bt, *_t(mod, q), ts, dropout_rng=JaxKey(key))
    (got * torch.from_numpy(w)).sum().backward()
    if bf16_dots:  # JAX casts x itself to bf16: the delta comes out bf16
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    for g_t, g_j in zip((got.detach().float(), xt.grad, at.grad, bt.grad),
                        (want, *jg)):
        g_j = np.asarray(g_j.astype(jnp.float32))
        # bf16 dots: the two sides round operands and cotangents to bf16
        # in other orders; allow two bf16 ulps (2^-7) of the largest value
        tol = dict(rtol=0, atol=2 ** -7 * np.abs(g_j).max()) if bf16_dots \
            else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g_t.numpy(), g_j, **tol)
    assert np.any(np.asarray(jg[0]) == 0)  # dropped inputs get no gradient


def test_dropout_key_bits():
    """Bits are a pure function of the key's path: the same path gives
    the same bits, other paths other bits; the keep rate of
    ``lora_dropout`` is Bernoulli(keep) within five standard deviations."""
    key = DropoutKey(42)
    a = key.split(3)[1].fold_in(4).bits((64, 512), "cpu")
    b = DropoutKey(42).split(3)[1].fold_in(4).bits((64, 512), "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 16
    others = [key.split(3)[0].fold_in(4), key.split(3)[1].fold_in(5),
              key.split(2)[1].fold_in(4), key.fold_in(4)]
    for k in others:
        assert not torch.equal(k.bits((64, 512), "cpu"), a)
    x = torch.ones((256, 1024))
    for rate in (0.05, 0.5):
        kept = float((tm.lora_dropout(x, key, rate) != 0).float().mean())
        n, keep = x.numel(), 1.0 - rate
        assert abs(kept - keep) <= 5 * math.sqrt(keep * rate / n)
        out = tm.lora_dropout(x, key, rate)
        assert torch.all((out == 0) | (out == torch.tensor(1 / keep)))


def test_dropout_survives_checkpoint_recompute():
    """A checkpointed function that drops its input out: the recompute in
    the backward draws the same bits (the key is not global RNG state), so
    the gradient equals that of the run without the checkpoint."""
    from torch.utils.checkpoint import checkpoint
    x = torch.randn((4, 33, 16), generator=torch.Generator().manual_seed(0))
    w = torch.randn((16, 8), generator=torch.Generator().manual_seed(1))
    key = DropoutKey(7).fold_in(2)

    def f(x_):
        return (tm.lora_dropout(x_, key, 0.3) @ w).pow(2).sum()

    grads = []
    for ckpt in (False, True):
        xg = x.clone().requires_grad_(True)
        loss = checkpoint(f, xg, use_reentrant=False) if ckpt else f(xg)
        loss.backward()
        grads.append(xg.grad)
    assert torch.equal(grads[0], grads[1])
    assert (grads[0] == 0).any()
