"""Port parity: prompt and prefix tuning (``adapters/prompt.py``) and
``ops/rope.py::rotate_half`` against the JAX package on the CPU, fp32,
``LlamaConfig.tiny(vocab_size=64)`` as ``tests/test_prompt_prefix.py``.

Both packages get the same parameters (drawn once with numpy; the
initializers draw from different generators and are checked for shape,
dtype and scale only).  Tolerances: the elementwise helpers exactly; the
logits to 1e-4, as ``test_torch_llama``; gradients to
``test_torch_train.GRAD`` (1e-4 relative + 1e-6 absolute: fp32 sums in
other orders).  Prefix tuning's gradient flows through the cache, which
the port's cached forward writes out of place when autograd records the
write.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.adapters import prompt as jprompt
from moka_tpu.core.config import LlamaConfig as JCfg
from moka_tpu.models import llama as jllama
from moka_tpu.ops import rope as jrope
from moka_tpu_torch.adapters import prompt as tprompt
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import rope as trope
from tests.test_torch_cli import one_thread
from tests.test_torch_train import GRAD

JCFG, CFG = JCfg.tiny(vocab_size=64), LlamaConfig.tiny(vocab_size=64)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread (test_torch_cli.one_thread): these
    are many small ops, and in the parallel run idle intra-op threads spin
    against the other workers."""
    with one_thread():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def base():
    jb = jllama.init_llama_params(jax.random.key(0), JCFG, dtype=jnp.float32)
    return jb, params_from_numpy(_np(jb), "cpu")


def _leaves_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **tol, err_msg=k)


def test_rotate_half_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(trope.rotate_half(_t(x)).numpy(),
                                  np.asarray(jrope.rotate_half(
                                      jnp.asarray(x))))


def test_initializers_shapes_and_scales(base):
    jb, tb = base
    g = torch.Generator().manual_seed(0)
    soft = tprompt.init_soft_prompt(g, CFG, 4, device="cpu")
    text = tprompt.init_soft_prompt(g, CFG, 4, embed_table=tb["embed"],
                                    device="cpu")
    assert soft.shape == text.shape == (4, CFG.dim)
    assert soft.dtype == text.dtype == torch.float32
    assert 0.005 < float(soft.std()) < 0.05
    assert all(any(torch.equal(r, e) for e in tb["embed"]) for r in text)
    pre = tprompt.init_prefix(g, CFG, 3, device="cpu")
    jpre = jprompt.init_prefix(jax.random.key(1), JCFG, 3)
    pt = tprompt.init_ptuning_encoder(g, CFG, 3, device="cpu")
    jpt = jprompt.init_ptuning_encoder(jax.random.key(1), JCFG, 3)
    mt = tprompt.init_multitask_prompt(g, CFG, 3, 2, device="cpu")
    jmt = jprompt.init_multitask_prompt(jax.random.key(1), JCFG, 3, 2)
    ap = tprompt.init_adaption_prompt(g, CFG, 5, 2, device="cpu")
    jap = jprompt.init_adaption_prompt(jax.random.key(1), JCFG, 5, 2)
    for got, want in ((pre, jpre), (pt, jpt), (mt, jmt), (ap, jap)):
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == torch.float32
    for k in ("b1", "b2"):
        assert not pt[k].any()
    assert (mt["task_cols"] == 1).all() and (mt["task_rows"] == 1).all()
    assert not ap["gate"].any()


def test_soft_prompt_matches_jax():
    rng = np.random.default_rng(1)
    prompt = rng.standard_normal((4, CFG.dim)).astype(np.float32)
    emb = rng.standard_normal((2, 6, CFG.dim)).astype(np.float32)
    mask = np.ones((2, 6), np.int32)
    mask[0, :2] = 0
    labels = rng.integers(0, 64, (2, 6)).astype(np.int32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want = jprompt.apply_soft_prompt(jnp.asarray(prompt), jnp.asarray(emb),
                                     jnp.asarray(mask), jnp.asarray(labels),
                                     jnp.asarray(pos))
    got = tprompt.apply_soft_prompt(_t(prompt), _t(emb), _t(mask),
                                    _t(labels), _t(pos))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    alone = tprompt.apply_soft_prompt(_t(prompt), _t(emb))
    assert alone[1] is None and alone[2] is None and alone[3] is None


def test_multitask_prompt_matches_jax():
    rng = np.random.default_rng(2)
    p = {"prompt": rng.standard_normal((3, CFG.dim)),
         "task_cols": rng.standard_normal((2, 3, 1)),
         "task_rows": rng.standard_normal((2, 1, CFG.dim))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ids = np.array([1, 0, 1])
    emb = rng.standard_normal((3, 5, CFG.dim)).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    labels = np.full((3, 5), 7, np.int64)
    pos = np.tile(np.arange(5), (3, 1))
    want = jprompt.apply_multitask_prompt(
        jax.tree.map(jnp.asarray, p), jnp.asarray(ids), jnp.asarray(emb),
        jnp.asarray(mask), jnp.asarray(labels), jnp.asarray(pos))
    got = tprompt.apply_multitask_prompt(
        {k: _t(v) for k, v in p.items()}, _t(ids), _t(emb), _t(mask),
        _t(labels), _t(pos))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ptuning_prompt_and_grads_match_jax(base):
    jb, tb = base
    rng = np.random.default_rng(3)
    enc = {"virtual": rng.standard_normal((3, 16)) * 0.5,
           "w1": rng.standard_normal((16, 16)) * 0.3,
           "b1": rng.standard_normal(16) * 0.1,
           "w2": rng.standard_normal((16, CFG.dim)) * 0.3,
           "b2": rng.standard_normal(CFG.dim) * 0.1}
    enc = {k: v.astype(np.float32) for k, v in enc.items()}
    toks = np.arange(12).reshape(2, 6) % 64

    def jloss(p):
        e, _, _, _ = jprompt.apply_soft_prompt(
            jprompt.ptuning_prompt(p), jnp.take(jb["embed"], toks, axis=0))
        logits, _ = jllama.forward(jb, JCFG, inputs_embeds=e)
        return jnp.sum(logits ** 2)

    jval, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, enc))
    tenc = {k: _t(v).requires_grad_() for k, v in enc.items()}
    e, _, _, _ = tprompt.apply_soft_prompt(
        tprompt.ptuning_prompt(tenc), tb["embed"][_t(toks)])
    logits, _ = tllama.forward(tb, CFG, inputs_embeds=e)
    val = (logits ** 2).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    _leaves_close({k: v.grad for k, v in tenc.items()}, jg, **GRAD)


def test_ln_tuning_split_merge_matches_jax(base):
    jb, tb = base
    toks = np.arange(12).reshape(2, 6) % 64
    rng = np.random.default_rng(4)
    jnorms, _ = jprompt.ln_tuning_split(jb)
    jnorms = jax.tree.map(
        lambda x: x + jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                                  jnp.float32), jnorms)

    def jloss(n):
        logits, _ = jllama.forward(jprompt.ln_tuning_merge(n, jb), JCFG,
                                   tokens=jnp.asarray(toks))
        return jnp.sum(logits ** 2)

    jval, jg = jax.value_and_grad(jloss)(jnorms)
    tnorms, frozen = tprompt.ln_tuning_split(tb)
    assert frozen is tb and tnorms["final_norm"] is tb["final_norm"]
    tnorms = {k: _t(v).requires_grad_() for k, v in jnorms.items()}
    merged = tprompt.ln_tuning_merge(tnorms, tb)
    assert merged["layers"]["q"] is tb["layers"]["q"]
    logits, _ = tllama.forward(merged, CFG, tokens=_t(toks))
    val = (logits ** 2).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    _leaves_close({k: v.grad for k, v in tnorms.items()}, jg, **GRAD)


def test_prefix_tuning_logits_and_grads_match_jax(base):
    """tests/test_prompt_prefix.py's prefix forward: the cache pre-filled
    from the prefixes, tokens at positions 3.., and the gradient of
    sum(logits^2) with respect to both prefixes."""
    jb, tb = base
    rng = np.random.default_rng(5)
    shape = (CFG.n_layers, 3, CFG.n_kv_heads, CFG.head_dim)
    pre = {"k": (rng.standard_normal(shape) * 0.5).astype(np.float32),
           "v": (rng.standard_normal(shape) * 0.5).astype(np.float32)}
    b, L = 2, 8
    toks = (np.arange(b * L).reshape(b, L) * 3 + 1) % 64
    pos = np.tile(np.arange(L) + 3, (b, 1))

    def jfwd(p):
        cache, pmask = jprompt.prefix_cache(p, JCFG, b, L, dtype=jnp.float32)
        attn = jnp.concatenate([pmask, jnp.ones((b, L), jnp.int32)], axis=1)
        logits, _ = jllama.forward(jb, JCFG, tokens=jnp.asarray(toks),
                                   cache=cache, attn_mask=attn,
                                   positions=jnp.asarray(pos))
        return logits

    jp = jax.tree.map(jnp.asarray, pre)
    jlogits = jfwd(jp)
    jg = jax.grad(lambda p: jnp.sum(jfwd(p) ** 2))(jp)

    tp = {k: _t(v).requires_grad_() for k, v in pre.items()}
    cache, pmask = tprompt.prefix_cache(tp, CFG, b, L)
    assert cache["length"] == 3 and isinstance(cache["length"], int)
    assert cache["k"].requires_grad and pmask.dtype == torch.int32
    attn = torch.cat([pmask, torch.ones((b, L), dtype=torch.int32)], dim=1)
    logits, new_cache = tllama.forward(tb, CFG, tokens=_t(toks), cache=cache,
                                       attn_mask=attn, positions=_t(pos))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    assert new_cache["length"] == 3 + L
    assert new_cache["k"] is not cache["k"]  # written out of place
    assert not cache["k"][:, :, 3:].any()    # the caller's cache as it was
    (logits ** 2).sum().backward()
    assert tp["k"].grad.abs().sum() > 0 and tp["v"].grad.abs().sum() > 0
    _leaves_close({k: v.grad for k, v in tp.items()}, jg, **GRAD)
    with torch.no_grad():  # serving keeps the in-place write
        cache, _ = tprompt.prefix_cache(tp, CFG, b, L)
        _, served = tllama.forward(tb, CFG, tokens=_t(toks), cache=cache,
                                   attn_mask=attn, positions=_t(pos))
    assert served["k"] is cache["k"]


def test_adaption_prompt_delta_and_grads_match_jax():
    rng = np.random.default_rng(6)
    H, K, hd, al = CFG.n_heads, CFG.n_kv_heads, CFG.head_dim, 5
    arrays = {"q": rng.standard_normal((2, 4, H, hd)),
              "prompt": rng.standard_normal((al, CFG.dim)),
              "k_w": rng.standard_normal((CFG.dim, K * hd)) * 0.1,
              "v_w": rng.standard_normal((CFG.dim, K * hd)) * 0.1,
              "o_w": rng.standard_normal((H * hd, CFG.dim)) * 0.1}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    gate = np.float32(0.7)

    def jloss(a, g):
        out = jprompt.adaption_prompt_delta(a["q"], a["prompt"], g,
                                            a["k_w"], a["v_w"], a["o_w"])
        return jnp.sum(out ** 2), out

    (jval, jout), (ja, jgate) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, arrays), jnp.asarray(gate))
    ta = {k: _t(v).requires_grad_() for k, v in arrays.items()}
    tgate = torch.tensor(gate, requires_grad=True)
    out = tprompt.adaption_prompt_delta(ta["q"], ta["prompt"], tgate,
                                        ta["k_w"], ta["v_w"], ta["o_w"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    (out ** 2).sum().backward()
    _leaves_close({k: v.grad for k, v in ta.items()}, ja, **GRAD)
    np.testing.assert_allclose(tgate.grad.item(), float(jgate), **GRAD)
