"""Port parity: ``moka_tpu_torch.ops.fused_dropout`` (TPU kernels 6-7)
against ``moka_tpu/ops/fused_dropout.py`` on the CPU, and the Philox words
of ``core.rng.DropoutKey.bits32`` that the CUDA kernels draw.

The JAX kernels run in Pallas interpret mode with ``_force_bits`` (block 16,
so b 2 x L 37 = 74 rows leave a ragged last block); the port takes the same
numpy uint32 words.  Tolerances: fp32 sums over d (forward) or N (dA) in
another order, 1e-5 relative + 1e-6 of the largest value; bf16 outputs (dx of a bf16
x, dA of a bf16 A) are rounded once on each side from fp32 sums that may
differ in the last bit, so one bf16 ulp (2^-7 of the largest value).  The
masks themselves are exact: a dropped element's dx is 0 on both sides.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg
from moka_tpu.models import llama as jllama
from moka_tpu.ops import moka as jm
from moka_tpu.ops.fused_dropout import dropout_a_proj as j_drop_a
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.rng import DropoutKey, philox4x32
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import fused_dropout as fd
from moka_tpu_torch.ops import moka as tm
from tests.test_torch_train import JaxKey


def _fp32(want):
    return dict(rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))


def _bf16_ulp(want):
    return dict(rtol=0, atol=2 ** -7 * float(np.abs(want).max()))


def _jdtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10's published known-answer vectors (Random123)."""
    words = philox4x32(tuple(torch.tensor([c]) for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def test_bits32_layout_and_determinism():
    """Element (n, c) is word c % 4 at counter (n, c // 4): fewer rows or
    columns are a corner of the same words (no dependence on the shape a
    kernel tiles), the same key gives the same words, other keys others."""
    key = DropoutKey(5).split(3)[2].fold_in(6)
    bits = key.bits32((37, 130), "cpu")
    assert bits.dtype == torch.int64 and tuple(bits.shape) == (37, 130)
    assert int(bits.min()) >= 0 and int(bits.max()) < 1 << 32
    assert torch.equal(bits, key.bits32((37, 130), "cpu"))
    assert torch.equal(bits[:20, :64], key.bits32((20, 64), "cpu"))
    assert torch.equal(bits[:, :129], key.bits32((37, 129), "cpu"))
    n, c = 11, 102
    words = philox4x32(tuple(torch.tensor([v]) for v in (n, c // 4, 0, 0)),
                       key.philox_key)
    assert int(bits[n, c]) == int(words[c % 4])
    for other in (DropoutKey(5).split(3)[1].fold_in(6), key.fold_in(0),
                  DropoutKey(6)):
        assert not torch.equal(other.bits32((37, 130), "cpu"), bits)
    lo, hi = key.philox_key
    assert (hi << 32) | lo == key.seed


def test_keep_share_within_five_sigma():
    """A ~1M-element draw keeps within 5 sigma of Bernoulli(0.95)."""
    bits = DropoutKey(11).bits32((1024, 1024), "cpu")
    for rate in (0.05, 0.5):
        keep = 1.0 - rate
        share = float((bits < fd.threshold(rate)).double().mean())
        assert abs(share - keep) <= 5 * np.sqrt(keep * rate / bits.numel())
    assert fd.threshold(0.05) == round(0.95 * 2 ** 32)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_dropout_a_proj_matches_jax(x_dtype, a_dtype, rate):
    """Forward and both gradients against the JAX kernels (interpret mode,
    forced bits, blocks of 16 rows: 74 rows leave a ragged block)."""
    b, L, d, M, r = 2, 37, 128, 3, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    a = (rng.standard_normal((M, d, r)) * 0.1).astype(np.float32)
    g = rng.standard_normal((M, b, L, r)).astype(np.float32)
    bits = rng.integers(0, 1 << 32, (b * L, d), dtype=np.uint64).astype(
        np.uint32)
    xj = jnp.asarray(x, _jdtype(x_dtype))
    aj = jnp.asarray(a, _jdtype(a_dtype))

    def jloss(x_, a_):
        out = j_drop_a(x_, a_, jax.random.key(0), rate, block_rows=16,
                       interpret=True, _force_bits=jnp.asarray(bits))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (jdx, jda) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(xj, aj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, x_dtype)).requires_grad_(True)
    at = torch.from_numpy(np.array(aj.astype(jnp.float32))).to(
        getattr(torch, a_dtype)).requires_grad_(True)
    got = fd.dropout_a_proj(xt, at, DropoutKey(0), rate,
                            _force_bits=torch.from_numpy(
                                bits.astype(np.int64)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, b, L, r)
    (got * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == xt.dtype and at.grad.dtype == at.dtype
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **_fp32(np.asarray(want)))
    for t, j, dt in ((xt.grad, jdx, x_dtype), (at.grad, jda, a_dtype)):
        j = np.asarray(j.astype(jnp.float32))
        tol = _fp32(j) if dt == "float32" else _bf16_ulp(j)
        np.testing.assert_allclose(t.float().numpy(), j, **tol)
    dropped = bits.reshape(b, L, d) >= fd.threshold(rate)
    assert np.all(xt.grad.float().numpy()[dropped] == 0)
    assert np.all(np.asarray(jdx.astype(jnp.float32))[dropped] == 0)


def test_dropout_a_proj_draws_the_keys_words():
    """Without forced bits the port drops by ``key.bits32``: equal to the
    same call forced with those words, and to ``dropout_a_proj_plain``, in
    value and gradient; a CPU tensor never launches a kernel."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 9, 40)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 40, 4)).astype(np.float32))
    key = DropoutKey(9).fold_in(3)
    before = (fd.dropout_a_fwd.launches, fd.dropout_a_bwd.launches)
    outs, grads = [], []
    for fn, kw in ((fd.dropout_a_proj, {}),
                   (fd.dropout_a_proj, {"_force_bits": key.bits32((27, 40),
                                                                  "cpu")}),
                   (fd.dropout_a_proj_plain, {})):
        xg, ag = x.clone().requires_grad_(True), a.clone().requires_grad_(True)
        out = fn(xg, ag, key, 0.3, **kw)
        out.pow(2).sum().backward()
        outs.append(out.detach())
        grads.append((xg.grad, ag.grad))
    for o, (gx, ga) in zip(outs[1:], grads[1:]):
        assert torch.equal(o, outs[0])
        assert torch.equal(gx, grads[0][0]) and torch.equal(ga, grads[0][1])
    assert (grads[0][0] == 0).any()
    assert (fd.dropout_a_fwd.launches, fd.dropout_a_bwd.launches) == before


def test_kernel_wrappers_check_their_inputs():
    """What the CUDA wrappers refuse (checked before any launch)."""
    x = torch.zeros((8, 64))
    a = torch.zeros((64, 12))
    key = DropoutKey(0)
    for bad in ((x.half(), a), (x, a.half()), (x[:, :62], a[:62]),
                (x, torch.zeros((64, 24))), (x, torch.zeros((64, 8))),
                (x, torch.zeros((60, 12)))):
        with pytest.raises((TypeError, ValueError)):
            fd._kernel_inputs(*bad, key, None)
    with pytest.raises(ValueError, match="bits"):
        fd._kernel_inputs(x, a, key, torch.zeros((8, 60), dtype=torch.int64))
    _, _, bits, k0, k1 = fd._kernel_inputs(
        x, a, key, torch.tensor([[0, (1 << 32) - 1] * 32] * 8))
    assert bits.dtype == torch.int32 and int(bits[0, 1]) == -1
    assert (k0, k1) == (0, 0)
    assert fd._kernel_inputs(x, a, key, None)[3:] == key.philox_key
    assert fd.bwd_row_tiles(4096) == 32 and fd.bwd_row_tiles(129) == 2


def _moka_inputs(seed, b=2, L=12, d=16, d_out=8, M=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    a = (rng.standard_normal((M, d, 4)) * 0.2).astype(np.float32)
    bm = (rng.standard_normal((4, d_out)) * 0.2).astype(np.float32)
    mod = np.zeros((M, b, L), np.float32)
    mod[0, :, :6], mod[1, :, 6:9], mod[2, :, 9:] = 1, 1, 1
    q = np.zeros((b, L), np.float32)
    q[0, 1:4] = 1  # row 1 has no question
    return x, a, bm, mod, q


@pytest.mark.parametrize("bf16_dots", [False, True])
def test_moka_delta_fused_dropout_matches_jax(bf16_dots):
    """``moka_delta`` with ``with_fused_dropout()``: the delta and its
    gradients in x, A and B against JAX's (which draws
    ``jax.random.bits(key, (b*L, d), uint32)`` on the CPU; the port's key
    hands it the same words)."""
    args = dict(rank=4, lora_alpha=16.0, blc_weight=0.7, dropout_rate=0.1)
    js = jm.MokaSpec.avt(**args).with_question_window(4).with_fused_dropout()
    ts = tm.MokaSpec.avt(**args).with_question_window(4).with_fused_dropout()
    if bf16_dots:
        js, ts = js.with_bf16_dots(), ts.with_bf16_dots()
    x, a, bm, mod, q = _moka_inputs(3)
    w = np.random.default_rng(4).standard_normal((2, 12, 8)).astype(
        np.float32)
    key = jax.random.key(5)

    def jloss(x_, a_, b_):
        out = jm.moka_delta(x_, a_, b_, jnp.asarray(mod), jnp.asarray(q), js,
                            dropout_rng=key)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *map(jnp.asarray, (x, a, bm)))
    xt, at, bt = (torch.from_numpy(v).requires_grad_(True) for v in (x, a, bm))
    got = tm.moka_delta(xt, at, bt, torch.from_numpy(mod), torch.from_numpy(q),
                        ts, dropout_rng=JaxKey(key))
    (got * torch.from_numpy(w)).sum().backward()
    for t, j in zip((got.detach(), xt.grad, at.grad, bt.grad), (want, *jg)):
        j = np.asarray(j)
        # bf16 dots: operands and cotangents rounded to bf16 at other
        # points on the two sides; two bf16 ulps of the largest value
        tol = dict(rtol=0, atol=2 ** -6 * np.abs(j).max()) if bf16_dots \
            else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t.numpy(), j, **tol)
    assert np.any(np.asarray(jg[0]) == 0)  # dropped inputs get no gradient


@pytest.mark.parametrize("shared", [False, True])
def test_forward_with_fused_dropout_matches_jax(shared):
    """The decoder with fused dropout (keys split per layer, folded per
    projection or per input group with shared masks) against JAX's."""
    cfg_j, cfg_t = JCfg.tiny(), LlamaConfig.tiny()
    js = jm.MokaSpec.avt(rank=4, dropout_rate=0.3).with_fused_dropout()
    ts = tm.MokaSpec.avt(rank=4, dropout_rate=0.3).with_fused_dropout()
    if shared:
        js, ts = js.with_shared_dropout_masks(), ts.with_shared_dropout_masks()
    r1, r2, r3 = jax.random.split(jax.random.key(1), 3)
    base = jllama.init_llama_params(r1, cfg_j, dtype=jnp.float32)
    ad = jllama.init_moka_adapters(r2, cfg_j, js)
    ad = {"layers": {n: {"a": p["a"], "b": jax.random.normal(
        jax.random.fold_in(r3, i), p["b"].shape) * 0.05}
        for i, (n, p) in enumerate(ad["layers"].items())}}
    _, _, _, mod, q = _moka_inputs(6, b=2, L=12)
    emb = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(
        np.float32)
    key = jax.random.key(3)
    want, _ = jllama.forward(base, cfg_j, adapters=ad, spec=js,
                             inputs_embeds=jnp.asarray(emb),
                             masks=jllama.MaskBundle(jnp.asarray(mod),
                                                     jnp.asarray(q)),
                             dropout_rng=key)
    tb = params_from_numpy(jax.tree.map(np.asarray, base), "cpu")
    ta = params_from_numpy(jax.tree.map(np.asarray, ad), "cpu")
    masks = tllama.MaskBundle(torch.from_numpy(mod), torch.from_numpy(q))
    got, _ = tllama.forward(tb, cfg_t, adapters=ta, spec=ts,
                            inputs_embeds=torch.from_numpy(emb), masks=masks,
                            use_flash=True, dropout_rng=JaxKey(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    clean, _ = tllama.forward(tb, cfg_t, adapters=ta,
                              spec=dataclasses.replace(ts, dropout_rate=0.0),
                              inputs_embeds=torch.from_numpy(emb),
                              masks=masks)
    assert not np.allclose(got.numpy(), clean.numpy(), atol=1e-4)
