"""Port parity: decoder, rope, rmsnorm, generation and sampling against the
JAX package on the CPU, fp32, with the JAX parameters converted through
``convert.params_from_numpy`` (no renaming).

Tolerances: fp32 on both sides with different summation orders; 1e-4 on
logits after two layers (values of order 1), 1e-5 on single ops.  Greedy
tokens must agree exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg
from moka_tpu.eval import decode as jdecode
from moka_tpu.eval import sampling as jsampling
from moka_tpu.models import llama as jllama
from moka_tpu.ops import rope as jrope
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, dump_config
from moka_tpu_torch.eval import decode as tdecode
from moka_tpu_torch.eval import sampling as tsampling
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import rope as trope
from moka_tpu_torch.ops.moka import MokaSpec

JCFG, CFG = JCfg.tiny(), LlamaConfig.tiny()
JSPEC = JSpec.avt(rank=4, dropout_rate=0.0)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    r1, r2, r3 = jax.random.split(jax.random.key(0), 3)
    base = jllama.init_llama_params(r1, JCFG, dtype=jnp.float32)
    ad = jllama.init_moka_adapters(r2, JCFG, JSPEC)
    # B starts at zero (a no-op adapter): give it seeded values
    bs = {n: jax.random.normal(jax.random.fold_in(r3, i), p["b"].shape) * 0.05
          for i, (n, p) in enumerate(ad["layers"].items())}
    ad = {"layers": {n: {"a": p["a"], "b": bs[n]}
                     for n, p in ad["layers"].items()}}
    return (base, ad), (params_from_numpy(_np(base), "cpu"),
                        params_from_numpy(_np(ad), "cpu"))


def _batch(seed=0, b=3, L=14, pads=(0, 3, 6)):
    """Left-padded multimodal prompts: (embeds, prompt mask, masks) numpy."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, L, CFG.dim)).astype(np.float32)
    pm = np.ones((b, L), np.float32)
    mod = np.zeros((3, b, L), np.float32)
    q = np.zeros((b, L), np.float32)
    for i, p in enumerate(pads):
        pm[i, :p] = 0
        n = L - p
        mod[0, i, p:p + n // 2] = 1
        mod[1, i, p + n // 2:p + 3 * n // 4] = 1
        mod[2, i, p + 3 * n // 4:] = 1
        q[i, p + 1:p + 4] = 1
    return emb, pm, mod, q


def test_config_presets_match_jax(tmp_path):
    for name in ("llama2_7b", "tiny"):
        jc, tc = getattr(JCfg, name)(), getattr(LlamaConfig, name)()
        assert {f: getattr(tc, f) for f in tc.__dataclass_fields__} == \
            {f: getattr(jc, f) for f in tc.__dataclass_fields__}
        assert tc.head_dim == jc.head_dim
    dump_config(CFG, str(tmp_path / "cfg.json"))
    assert '"dim": 64' in (tmp_path / "cfg.json").read_text()


@pytest.mark.parametrize("scaling,seq_len", [(None, None), (("linear", 2.0), None),
                                             (("dynamic", 2.0), 300),
                                             (("dynamic", 2.0), 100)])
def test_rope_matches_jax(scaling, seq_len):
    pos = np.arange(24, dtype=np.int32).reshape(2, 12)
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0, scaling,
                                seq_len=seq_len, max_seq_len=256)
    ct, st = trope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0, scaling,
                                seq_len=seq_len, max_seq_len=256)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)
    x = np.random.default_rng(0).standard_normal((2, 12, 3, 16)).astype(
        np.float32)
    want = jrope.apply_rope(jnp.asarray(x), cj, sj)
    got = trope.apply_rope(torch.from_numpy(x), ct, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rope_and_rmsnorm_run_in_x_dtype():
    """The rotation uses half-width tables cast to x's dtype; rmsnorm casts
    to x's dtype before multiplying by w (bf16 in, bf16 out, as in JAX)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 16)
    want = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), cj, sj)
    ct, st = trope.rope_cos_sin(torch.from_numpy(pos), 16)
    got = trope.apply_rope(torch.from_numpy(x).bfloat16(), ct, st)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)  # bf16 ulps
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    want = jllama.rmsnorm(jnp.asarray(h), jnp.asarray(w), 1e-5)
    got = tllama.rmsnorm(torch.from_numpy(h), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    hb = torch.from_numpy(h).bfloat16()
    assert tllama.rmsnorm(hb, torch.from_numpy(w).bfloat16(),
                          1e-5).dtype == torch.bfloat16


@pytest.mark.parametrize("use_flash,fused", [(False, False), (True, True)])
def test_forward_matches_jax(model, use_flash, fused):
    """Cache-less forward with masks and left padding: the port (plain or
    kernel entry points, which take their plain versions on the CPU)
    against the JAX eager path, on valid positions."""
    (jb, ja), (tb, ta) = model
    emb, pm, mod, q = _batch()
    want, _ = jllama.forward(jb, JCFG, adapters=ja, spec=JSPEC,
                             inputs_embeds=jnp.asarray(emb),
                             masks=jllama.MaskBundle(jnp.asarray(mod),
                                                     jnp.asarray(q)),
                             attn_mask=jnp.asarray(pm))
    tm = params_from_numpy(jllama.MaskBundle(mod, q), "cpu")
    got, cache = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                                inputs_embeds=torch.from_numpy(emb),
                                masks=tm, attn_mask=torch.from_numpy(pm),
                                use_flash=use_flash, use_fused_moka=fused)
    assert cache is None
    valid = pm[..., None] > 0
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(want) * valid,
                               **TOL)


def test_cached_prefill_and_step_match_jax_and_full_forward(model):
    """Prefill into a cache, then one decode step: logits, cache contents
    and the step's logits against JAX, and the step against a cache-less
    forward over the whole sequence."""
    (jb, ja), (tb, ta) = model
    rng = np.random.default_rng(2)
    b, L, S = 2, 9, 16
    toks = rng.integers(3, CFG.vocab_size, (b, L + 1)).astype(np.int32)
    mask = np.zeros((b, S), np.float32)
    mask[:, :L] = 1
    jcache = jllama.init_kv_cache(JCFG, b, S, dtype=jnp.float32)
    tcache = tllama.init_kv_cache(CFG, b, S, dtype=torch.float32,
                                  device="cpu")
    jl, jcache = jllama.forward(jb, JCFG, adapters=ja, spec=JSPEC,
                                tokens=jnp.asarray(toks[:, :L]),
                                attn_mask=jnp.asarray(mask), cache=jcache)
    tl, tcache2 = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                                 tokens=torch.from_numpy(toks[:, :L]),
                                 attn_mask=torch.from_numpy(mask),
                                 cache=tcache, use_flash=True)
    assert tcache2["k"] is tcache["k"] and tcache2["length"] == L
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for side in ("k", "v"):
        np.testing.assert_allclose(tcache2[side].numpy(),
                                   np.asarray(jcache[side]), **TOL)
    mask[:, L] = 1
    pos = np.full((b, 1), L, np.int32)
    jl1, _ = jllama.forward(jb, JCFG, adapters=ja, spec=JSPEC,
                            tokens=jnp.asarray(toks[:, L:]),
                            attn_mask=jnp.asarray(mask),
                            positions=jnp.asarray(pos), cache=jcache)
    tl1, tcache3 = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                                  tokens=torch.from_numpy(toks[:, L:]),
                                  attn_mask=torch.from_numpy(mask),
                                  positions=torch.from_numpy(pos),
                                  cache=tcache2)
    assert tcache3["length"] == L + 1
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    full, _ = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                             tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(tl1[:, 0].numpy(), full[:, -1].numpy(), **TOL)


def test_greedy_generate_matches_jax(model):
    """Token-for-token, with modality masks and left padding; the port's
    prefill runs the flash and fused-MokA entry points."""
    (jb, ja), (tb, ta) = model
    emb, pm, mod, q = _batch(seed=3)
    want = np.asarray(jdecode.greedy_generate(
        jb, ja, cfg=JCFG, spec=JSPEC, inputs_embeds=jnp.asarray(emb),
        prompt_mask=jnp.asarray(pm),
        masks=jllama.MaskBundle(jnp.asarray(mod), jnp.asarray(q)),
        max_new_tokens=8, eos_id=2, use_flash=False, paged_decode=False))
    tmasks = params_from_numpy(jllama.MaskBundle(mod, q), "cpu")
    for flags in (dict(), dict(use_flash=True, use_fused_moka=True)):
        got = tdecode.greedy_generate(
            tb, ta, cfg=CFG, spec=SPEC, inputs_embeds=torch.from_numpy(emb),
            prompt_mask=torch.from_numpy(pm), masks=tmasks,
            max_new_tokens=8, eos_id=2, **flags)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_greedy_generate_quantized_base_matches_jax(model, bits):
    """Serving a weight-only int8 or int4 base with an int8 lm_head, as
    ``moka_tpu/cli/infer.py`` imports one: the same tokens."""
    from moka_tpu.ops.quant import quantize_llama_base
    (jb, ja), (_, ta) = model
    jq = quantize_llama_base(jb, bits=bits, head_bits=8)
    emb, pm, mod, q = _batch(seed=5)
    want = np.asarray(jdecode.greedy_generate(
        jq, ja, cfg=JCFG, spec=JSPEC, inputs_embeds=jnp.asarray(emb),
        prompt_mask=jnp.asarray(pm),
        masks=jllama.MaskBundle(jnp.asarray(mod), jnp.asarray(q)),
        max_new_tokens=8, eos_id=-1, use_flash=False, paged_decode=False))
    tq = params_from_numpy(_np(jq), "cpu")
    assert tq["layers"]["q"]["w_i4" if bits == 4 else "w_i8"].dtype == \
        (torch.uint8 if bits == 4 else torch.int8)
    got = tdecode.greedy_generate(
        tq, ta, cfg=CFG, spec=SPEC, inputs_embeds=torch.from_numpy(emb),
        prompt_mask=torch.from_numpy(pm),
        masks=params_from_numpy(jllama.MaskBundle(mod, q), "cpu"),
        max_new_tokens=8, eos_id=-1, use_flash=True, use_fused_moka=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_eos_padding_matches_jax(model):
    """Rows stop at eos (pad_id afterwards): take eos = a token the JAX run
    emits mid-sequence."""
    (jb, ja), (tb, ta) = model
    emb, pm, _, _ = _batch(seed=4)
    kw = dict(cfg=JCFG, spec=JSPEC, inputs_embeds=jnp.asarray(emb),
              prompt_mask=jnp.asarray(pm), masks=None, max_new_tokens=10,
              use_flash=False, paged_decode=False)
    free = np.asarray(jdecode.greedy_generate(jb, ja, eos_id=-1, **kw))
    eos = int(free[0, 3])
    want = np.asarray(jdecode.greedy_generate(jb, ja, eos_id=eos, pad_id=7,
                                              **kw))
    got = tdecode.greedy_generate(
        tb, ta, cfg=CFG, spec=SPEC, inputs_embeds=torch.from_numpy(emb),
        prompt_mask=torch.from_numpy(pm), masks=None, max_new_tokens=10,
        eos_id=eos, pad_id=7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 7).any()


def test_positions_from_mask_matches_jax():
    pm = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], np.float32)
    np.testing.assert_array_equal(
        tdecode.positions_from_mask(torch.from_numpy(pm)).numpy(),
        np.asarray(jdecode.positions_from_mask(jnp.asarray(pm))))
    assert tdecode.paged_decode_auto(CFG, 4096) is False


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.7),
                                         (4, 0.5)])
def test_sample_tokens_with_fed_noise_match_jax(top_k, top_p):
    """Same logits and the same Gumbel noise (drawn by JAX, fed to the
    port): the same tokens; per-row temperatures include a greedy row."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 50)).astype(np.float32) * 3
    temp = np.array([1.0, 0.7, 0.0, 1.5], np.float32)
    key = jax.random.key(11)
    want = jsampling.sample_tokens(jnp.asarray(logits), key,
                                   jnp.asarray(temp), top_k, top_p)
    noise = np.array(jax.random.gumbel(key, (4, 50), jnp.float32))
    got = tsampling.sample_tokens(torch.from_numpy(logits), None,
                                  torch.from_numpy(temp), top_k, top_p,
                                  gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fj = jsampling.filter_logits(jnp.asarray(logits), top_k, top_p)
    ft = tsampling.filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_sample_generate_zero_temperature_is_greedy(model):
    _, (tb, ta) = model
    emb, pm, mod, q = _batch(seed=6)
    kw = dict(cfg=CFG, spec=SPEC, inputs_embeds=torch.from_numpy(emb),
              prompt_mask=torch.from_numpy(pm), masks=None,
              max_new_tokens=6, eos_id=-1)
    greedy = tdecode.greedy_generate(tb, ta, **kw)
    sampled = tdecode.sample_generate(tb, ta, temperature=0.0, **kw)
    np.testing.assert_array_equal(sampled.numpy(), greedy.numpy())
    hot = tdecode.sample_generate(
        tb, ta, temperature=5.0,
        generator=torch.Generator().manual_seed(1), **kw)
    assert hot.shape == greedy.shape and not torch.equal(hot, greedy)


def test_params_from_numpy_keeps_layout_and_bf16():
    r = jax.random.key(1)
    base = jllama.init_llama_params(r, JCFG, dtype=jnp.bfloat16)
    tb = params_from_numpy(_np(base), "cpu")
    assert set(tb) == set(base) and set(tb["layers"]) == set(base["layers"])
    assert tb["layers"]["q"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb["layers"]["down"].float().numpy(),
        np.asarray(base["layers"]["down"].astype(jnp.float32)))
    t32 = params_from_numpy({"w": np.ones(3, np.float16),
                             "i": np.arange(3)}, "cpu", torch.float32)
    assert t32["w"].dtype == torch.float32 and t32["i"].dtype == torch.int64


def test_unported_forward_options_raise(model):
    """The parallelism options are ported (``tests/test_torch_ring.py``,
    ``tests/test_torch_mesh.py``): context parallelism with a cache raises
    as in JAX, and ``host_stream`` on a base already on the compute device
    gives the resident forward's logits; ``paged_decode`` (a no-op without
    a cache, as in JAX) and the int8 cache are ported
    (tests/test_torch_kv_cache.py)."""
    _, (tb, ta) = model
    toks = torch.zeros((1, 4), dtype=torch.int64)
    cache = tllama.init_kv_cache(CFG, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="context_parallel is a training"):
        tllama.forward(tb, CFG, adapters=ta, spec=SPEC, tokens=toks,
                       cache=cache, attn_mask=torch.ones((1, 8)),
                       context_parallel=object())
    streamed, _ = tllama.forward(tb, CFG, adapters=ta, spec=SPEC,
                                 tokens=toks, host_stream={})
    # the named remat policies are ported; an unknown name raises as in JAX
    with pytest.raises(ValueError, match="unknown remat policy"):
        tllama.forward(tb, CFG, adapters=ta, spec=SPEC, tokens=toks,
                       remat=True, remat_policy="nope")
    plain, _ = tllama.forward(tb, CFG, adapters=ta, spec=SPEC, tokens=toks)
    paged, _ = tllama.forward(tb, CFG, adapters=ta, spec=SPEC, tokens=toks,
                              paged_decode=True)
    assert torch.equal(plain, paged)
    assert torch.equal(plain, streamed)
    cache = tllama.init_kv_cache(CFG, 1, 8, quantized=True, device="cpu")
    assert cache["k"]["q"].dtype == torch.int8


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


@pytest.mark.parametrize("fused,shared", [(False, False), (True, False),
                                          (False, True)])
def test_forward_with_dropout_matches_jax(model, fused, shared):
    """LoRA dropout in the decoder: the key split per layer and folded per
    projection (or per input group with shared masks) as in JAX, the port
    fed the bits JAX draws; the port's fused MokA path drops out x outside
    the kernel, against the JAX unfused path on the same masks."""
    (jb, ja), (tb, ta) = model
    emb, pm, mod, q = _batch(seed=7)
    js, ts = (JSpec.avt(rank=4, dropout_rate=0.3),
              MokaSpec.avt(rank=4, dropout_rate=0.3))
    if shared:
        js, ts = js.with_shared_dropout_masks(), ts.with_shared_dropout_masks()
    key = jax.random.key(3)
    want, _ = jllama.forward(jb, JCFG, adapters=ja, spec=js,
                             inputs_embeds=jnp.asarray(emb),
                             masks=jllama.MaskBundle(jnp.asarray(mod),
                                                     jnp.asarray(q)),
                             attn_mask=jnp.asarray(pm), dropout_rng=key)
    tm = params_from_numpy(jllama.MaskBundle(mod, q), "cpu")
    got, _ = tllama.forward(tb, CFG, adapters=ta, spec=ts,
                            inputs_embeds=torch.from_numpy(emb), masks=tm,
                            attn_mask=torch.from_numpy(pm), use_flash=True,
                            use_fused_moka=fused, dropout_rng=JaxKey(key))
    valid = pm[..., None] > 0
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(want) * valid,
                               **TOL)
    clean, _ = tllama.forward(tb, CFG, adapters=ta, spec=ts,
                              inputs_embeds=torch.from_numpy(emb), masks=tm,
                              attn_mask=torch.from_numpy(pm))
    assert not np.allclose(got.numpy() * valid, clean.numpy() * valid)
