"""Port parity: the int8 KV cache and the length-aware decode attention
(``models/llama.py``'s cache branches, ``ops/paged_decode.py``,
``eval/decode.py``'s paged path and ``eval/engine.py`` on the ``{"q",
"s"}`` layout) against the JAX package on the CPU, fp32, tiny config.

Tolerances: ``_kv_quantize``'s codes and scales bit-exact (the same fp32
max, division and half-to-even rounding); the block loop's output within
1e-5 (fp32 sums of at most 32 terms in other orders); logits after two
layers within 1e-4, as ``test_torch_llama``; greedy tokens and the
engine's tokens exactly equal.  The kernel itself runs only on the card
(``chip_smoke.py`` phase 3, ``test_torch_package.py``'s card test).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.eval import decode as jdecode
from moka_tpu.eval.engine import DecodeEngine as JEngine
from moka_tpu.models import llama as jllama
from moka_tpu.ops.attention import causal_bias as jcausal_bias
from moka_tpu.ops.attention import mha as jmha
from moka_tpu.ops.paged_decode import paged_decode_attention as jpaged
from moka_tpu_torch.eval import decode as tdecode
from moka_tpu_torch.eval.engine import DecodeEngine
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                             paged_decode_attention_plain)
from tests.test_torch_cli import one_thread
from tests.test_torch_llama import (CFG, JCFG, JSPEC, SPEC, TOL, _batch,
                                    model)  # noqa: F401 (fixture)

LOOP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread (test_torch_cli.one_thread): these
    are many small ops, and in the parallel run idle intra-op threads spin
    against the other workers."""
    with one_thread():
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def test_kv_quantize_bit_exact():
    """Codes and scales equal JAX's, with an all-zero row (scale 1, codes
    0) and values that land on .5 ties (half to even: 0.5 -> 0, 1.5 -> 2,
    2.5 -> 2, -0.5 -> 0)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 3, 16)) * 3.0).astype(np.float32)
    x[0, 1, 2] = 0.0
    # row max 127 makes the scale exactly 1: every code is x rounded
    x[1, 0, 0] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                           126.5, -126.5, 0, 0, 0, 0, 0, 0], np.float32)
    jq, js = jllama._kv_quantize(jnp.asarray(x))
    tq, ts = tllama._kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 2, 0] == 1.0 and (tq[0, 1, 2] == 0).all()
    assert tq[1, 0, 0, :10].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126,
                                         -126]


def _loop_case(KH, G, seed, quantized, S=32, N=3, B=3, hd=8):
    rng = np.random.default_rng(seed)
    H = KH * G
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    ck = rng.standard_normal((N, B, S, KH, hd)).astype(np.float32)
    cv = rng.standard_normal((N, B, S, KH, hd)).astype(np.float32)
    length = 19  # not a multiple of the block: part of a block is valid
    ck[:, :, length:] = 1e6   # a poisoned tail past `length`
    cv[:, :, length:] = -1e6
    mask = np.zeros((B, S), np.int32)
    mask[0, 3:] = 1           # left padding
    mask[1, :] = 1
    # row 2 sees no key (the loop gives it the mean of the values walked)
    if not quantized:
        return q, ck, cv, mask, length
    kq, ks = jllama._kv_quantize(jnp.asarray(ck))
    vq, vs = jllama._kv_quantize(jnp.asarray(cv))
    return q, {"q": np.asarray(kq), "s": np.asarray(ks)}, \
        {"q": np.asarray(vq), "s": np.asarray(vs)}, mask, length


def _side(x, conv):
    return {k: conv(v) for k, v in x.items()} if isinstance(x, dict) \
        else conv(x)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("KH,G", [(2, 1), (2, 2)])
def test_paged_loop_matches_jax(KH, G, quantized):
    """The plain loop against JAX's at block_k 8 (3 blocks walked, the last
    in part), on a plain and an int8 cache, left padding, a poisoned tail
    and a row that sees no key: within 1e-5 on every row."""
    q, ck, cv, mask, length = _loop_case(KH, G, 1, quantized)
    layer = 1
    want = jpaged(jnp.asarray(q), _side(ck, jnp.asarray),
                  _side(cv, jnp.asarray), jnp.asarray(mask), layer, length,
                  block_k=8)
    got = paged_decode_attention(_t(q), _side(ck, _t), _side(cv, _t),
                                 _t(mask), layer, length, block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)
    assert paged_decode_attention.launches == 0  # the CPU: no kernel
    if not quantized:  # the rows that see a key: eager attention's answer
        bias = jcausal_bias(jnp.asarray(mask), 1, 32, q_offset=length - 1)
        eager = jmha(jnp.asarray(q), jnp.asarray(ck[layer]),
                     jnp.asarray(cv[layer]), bias)
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(eager)[:2],
                                   rtol=2e-5, atol=2e-5)


def test_paged_loop_checks_the_block_multiple():
    q, ck, cv, mask, length = _loop_case(2, 1, 2, False, S=40)
    for fn in (paged_decode_attention, paged_decode_attention_plain):
        with pytest.raises(ValueError, match="multiple of block_k 32"):
            fn(_t(q), _t(ck), _t(cv), _t(mask), 0, length, block_k=32)
    with pytest.raises(ValueError, match="multiple of block_k"):
        jpaged(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
               jnp.asarray(mask), 0, length, block_k=32)


def test_int8_cache_layout_and_update():
    c = tllama.init_kv_cache(CFG, 2, 8, quantized=True, device="cpu")
    j = jllama.init_kv_cache(JCFG, 2, 8, quantized=True)
    for side in ("k", "v"):
        for leaf in ("q", "s"):
            assert tuple(c[side][leaf].shape) == j[side][leaf].shape
            assert str(c[side][leaf].dtype).split(".")[-1] == \
                str(j[side][leaf].dtype)
            np.testing.assert_array_equal(c[side][leaf].numpy(),
                                          np.asarray(j[side][leaf]))
    assert c["length"] == 0 and isinstance(c["length"], int)
    assert tllama.kv_cache_shape(c) == jllama.kv_cache_shape(j)
    new = np.random.default_rng(3).standard_normal(
        (2, 3, CFG.n_kv_heads, CFG.head_dim)).astype(np.float32)
    side = tllama._kv_update(c["k"], _t(new), 1, 4)
    jside = jllama._kv_update(j["k"], jnp.asarray(new), (1, 0, 4, 0, 0))
    assert side is c["k"]  # written in place
    for leaf in ("q", "s"):
        np.testing.assert_array_equal(side[leaf].numpy(),
                                      np.asarray(jside[leaf]))
    np.testing.assert_array_equal(
        tllama._kv_layer(side, 1, torch.float32).numpy(),
        np.asarray(jllama._kv_layer(jside, 1, jnp.float32)))


@pytest.mark.parametrize("paged", [False, True])
def test_forward_on_int8_cache_matches_jax(model, paged):
    """Prefill of left-padded prompts into an int8 cache (attention over
    the dequantized prompt k/v), then one decode step, eager or paged:
    logits and the cache leaves against JAX's (scales and logits 1e-4;
    codes within 1, since k/v computed 1e-6 apart may round to
    neighbouring codes)."""
    (jb, ja), (tb, ta) = model
    emb, pm, mod, qm = _batch(seed=4)
    b, L = pm.shape
    S = 32
    cmask = np.zeros((b, S), np.float32)
    cmask[:, :L] = pm
    pos = np.maximum(np.cumsum(pm, -1) - 1, 0).astype(np.int32)
    jm = jllama.MaskBundle(jnp.asarray(mod), jnp.asarray(qm))
    tm = tllama.MaskBundle(_t(mod), _t(qm))
    jc = jllama.init_kv_cache(JCFG, b, S, dtype=jnp.float32, quantized=True)
    tc = tllama.init_kv_cache(CFG, b, S, dtype=torch.float32, quantized=True,
                              device="cpu")
    jl, jc = jllama.forward(jb, JCFG, adapters=ja, spec=JSPEC,
                            inputs_embeds=jnp.asarray(emb), masks=jm,
                            attn_mask=jnp.asarray(cmask),
                            positions=jnp.asarray(pos), cache=jc)
    tl, tc = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                            inputs_embeds=_t(emb), masks=tm,
                            attn_mask=_t(cmask), positions=_t(pos), cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    cmask[:, L] = 1
    tok = np.array([[5], [9], [11]])
    step_pos = pm.sum(-1).astype(np.int32)[:, None]
    jl1, jc1 = jllama.forward(jb, JCFG, adapters=ja, spec=JSPEC,
                              tokens=jnp.asarray(tok),
                              attn_mask=jnp.asarray(cmask),
                              positions=jnp.asarray(step_pos), cache=jc,
                              paged_decode=paged)
    tl1, tc1 = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                              tokens=_t(tok), attn_mask=_t(cmask),
                              positions=_t(step_pos), cache=tc,
                              paged_decode=paged)
    assert tc1["length"] == L + 1
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    for side in ("k", "v"):
        got, want = tc1[side], jc1[side]
        # a code may sit on a rounding edge of values ~1e-6 apart
        assert (np.abs(got["q"].numpy().astype(np.int32) -
                       np.asarray(want["q"]).astype(np.int32)) <= 1).all()
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                                   **TOL)


def _gen_inputs(seed=3, b=2, L=20):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, L, CFG.dim)).astype(np.float32)
    pmask = np.ones((b, L), np.float32)
    pmask[0, :5] = 0  # left padding
    return embeds, pmask


@pytest.mark.parametrize("kv_quant,paged", [(True, False), (True, True),
                                            (False, True)])
def test_greedy_generate_matches_jax(model, kv_quant, paged):
    """Greedy tokens with the int8 cache and/or the paged loop (L + 12 = 32
    cells, rounded up to 256 for the paged allocation as JAX does):
    JAX's tokens exactly."""
    (jb, ja), (tb, ta) = model
    emb, pm = _gen_inputs()
    kw = dict(masks=None, max_new_tokens=12, eos_id=10 ** 9, pad_id=0,
              use_flash=False, paged_decode=paged, kv_quant=kv_quant)
    want = np.asarray(jdecode.greedy_generate(
        jb, ja, cfg=JCFG, spec=JSPEC, inputs_embeds=jnp.asarray(emb),
        prompt_mask=jnp.asarray(pm), **kw))
    got = tdecode.greedy_generate(tb, ta, cfg=CFG, spec=SPEC,
                                  inputs_embeds=_t(emb),
                                  prompt_mask=_t(pm), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_decode_auto_only_on_the_card():
    """False for CPU tensors and without a device, as JAX answers False off
    the TPU; on a card device only for a model the kernel takes, and then
    at every capacity on either cache (no threshold: the card's readings,
    chip_smoke.py phase 16)."""
    for dev in (None, "cpu", torch.device("cpu")):
        for kv in (False, True):
            assert tdecode.paged_decode_auto(CFG, 4096, kv, device=dev) \
                is False
    from moka_tpu_torch.core.config import LlamaConfig
    big = LlamaConfig.llama2_7b()
    for cap in (256, 512, 4096):
        for kv in (False, True):
            assert tdecode.paged_decode_auto(big, cap, kv, device="cuda")
    assert not tdecode.paged_decode_auto(big, 4096, True, device="cuda",
                                         dtype=torch.float32)
    assert not tdecode.paged_decode_auto(CFG, 4096, True, device="cuda")


@pytest.mark.parametrize("paged", [False, True])
def test_engine_kv_quant_matches_jax(model, paged):
    """``DecodeEngine(kv_quant=True)`` (insert, steps, compaction at
    capacity 32) against JAX's engine on the same requests: tokens
    exactly."""
    (jb, ja), (tb, ta) = model
    kw = dict(n_slots=2, cache_capacity=32, eos_id=2, use_flash=False,
              paged_decode=paged, kv_quant=True)
    want = _run_engine(JEngine(jb, ja, cfg=JCFG, spec=JSPEC, **kw),
                       lambda t: jnp.take(jb["embed"], jnp.asarray(t)[None],
                                          axis=0))
    eng = DecodeEngine(tb, ta, cfg=CFG, spec=SPEC, cache_dtype=torch.float32,
                       **kw)
    got = _run_engine(eng, lambda t: tb["embed"][torch.from_numpy(t).long()]
                      [None])
    assert got == want
    assert isinstance(eng.gk, dict) and eng.gk["q"].dtype == torch.int8


def _run_engine(engine, embed):
    """Five prompts of 4-9 tokens (seed 4), bucket-padded to 16, 10 new
    tokens each, drained; the token lists in submission order."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(4, CFG.vocab_size,
                            rng.integers(4, 10)).astype(np.int32)
               for _ in range(5)]
    waiters = []
    for p in prompts:
        padded = np.zeros(16, np.int32)
        padded[:len(p)] = p
        mask = np.zeros((1, 16), np.float32)
        mask[0, :len(p)] = 1
        waiters.append(engine.submit(embed(padded), mask, max_new_tokens=10))
    engine.run_until_drained()
    return [w.get(timeout=5).tolist() for w in waiters]


def test_engine_decodes_with_adapters_that_require_grad(model):
    """A ``DecodeEngine`` on a bf16-layout (here fp32) cache given adapter
    tensors that require grad (a trainer's live tree) with autograd on
    decodes as on detached ones, tokens exactly: its steps write the
    cache in place, which ``llama.forward`` does only where autograd
    records nothing."""
    _, (tb, ta) = model
    live = {"layers": {n: {k: v.detach().clone().requires_grad_(True)
                           for k, v in p.items()}
                       for n, p in ta["layers"].items()},
            **{k: v for k, v in ta.items() if k != "layers"}}
    kw = dict(cfg=CFG, spec=SPEC, cache_dtype=torch.float32, n_slots=2,
              cache_capacity=32, eos_id=2, use_flash=False)

    def embed(t):
        return tb["embed"][torch.from_numpy(t).long()][None]

    with torch.enable_grad():
        want = _run_engine(DecodeEngine(tb, ta, **kw), embed)
        got = _run_engine(DecodeEngine(tb, live, **kw), embed)
    assert got == want
