"""Port parity: every tuner of ``moka_tpu_torch.adapters.peft`` against
``moka_tpu/adapters/peft.py`` on the CPU in fp32, the same numpy inputs on
both sides, outputs and gradients (BOFT has its own file,
``test_torch_fbd.py``).  The init functions draw from a generator instead
of a key, so their numbers differ from JAX's: each is checked for shapes,
ranges and zeros, and each JAX-initialised tree crosses with
``convert.params_from_numpy`` unchanged.  Poly's training noise is fed the
uniform numbers JAX drew.

Tolerances: outputs 1e-5 relative + absolute (fp32 sums in another order),
gradients 2e-4 relative + 1e-6 (``tests/test_moka_op.py``'s)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.adapters import peft as jp
from moka_tpu_torch.adapters import peft as tp
from moka_tpu_torch.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=1e-6)
D_IN, D_OUT = 16, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(fn_j, fn_t, x, w, params, cot, *extra_j, **extra_t):
    """Output and gradients in every parameter of ``fn(x, w, p)``, JAX vs
    port; ``params`` a dict of numpy arrays."""
    want = fn_j(jnp.asarray(x), jnp.asarray(w),
                jax.tree.map(jnp.asarray, params), *extra_j)
    jg = jax.grad(lambda p: jnp.sum(fn_j(jnp.asarray(x), jnp.asarray(w), p,
                                         *extra_j) * cot))(
        jax.tree.map(jnp.asarray, params))
    tpar = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    got = fn_t(torch.tensor(x), torch.tensor(w), tpar, **extra_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    names = sorted(tpar)
    tg = torch.autograd.grad((got * torch.tensor(cot)).sum(),
                             [tpar[k] for k in names], allow_unused=True)
    for k, g in zip(names, tg):
        w_ = np.asarray(jg[k])
        if g is None:  # no path to the output (AdaLoRA's detached mask)
            assert not w_.any(), k
            continue
        np.testing.assert_allclose(g.numpy(), w_, err_msg=k, **GRAD)


def _data(seed, batch=(2, 5)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*batch, D_IN)).astype(np.float32)
    w = (rng.standard_normal((D_IN, D_OUT)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((*batch, D_OUT)).astype(np.float32)
    return rng, x, w, cot


def _rand(rng, *shape, s=0.3):
    return (rng.standard_normal(shape) * s).astype(np.float32)


@pytest.mark.parametrize("use_rslora", [False, True])
def test_lora_linear_and_merge_match_jax(use_rslora):
    rng, x, w, cot = _data(0)
    js = jp.LoraSpec(rank=4, alpha=8.0, use_rslora=use_rslora)
    ts = tp.LoraSpec(rank=4, alpha=8.0, use_rslora=use_rslora)
    assert ts.scale == js.scale
    p = {"a": _rand(rng, D_IN, 4), "b": _rand(rng, 4, D_OUT)}
    _both(lambda x_, w_, p_: jp.lora_linear(x_, w_, p_, js),
          lambda x_, w_, p_: tp.lora_linear(x_, w_, p_, ts), x, w, p, cot)
    merged = tp.merge_lora(torch.tensor(w), params_from_numpy(p, "cpu"), ts)
    np.testing.assert_allclose(
        merged.numpy(), np.asarray(jp.merge_lora(
            jnp.asarray(w), jax.tree.map(jnp.asarray, p), js)), **TOL)


def test_ia3_matches_jax():
    rng, x, w, cot = _data(1)
    p = {"scale": (1 + _rand(rng, D_OUT)).astype(np.float32)}
    _both(jp.ia3_linear, tp.ia3_linear, x, w, p, cot)


def test_oft_matches_jax():
    rng, x, w, cot = _data(2)
    p = {"q": _rand(rng, D_IN // 4, 4, 4, s=0.2)}
    _both(jp.oft_linear, tp.oft_linear, x, w, p, cot)
    ow = tp.oft_weight(torch.tensor(w), params_from_numpy(p, "cpu"))
    np.testing.assert_allclose(ow.norm(dim=0).numpy(),
                               np.linalg.norm(w, axis=0), rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_loha_lokr_vera_match_jax(scale):
    rng, x, w, cot = _data(3)
    loha = {"a1": _rand(rng, D_IN, 4), "b1": _rand(rng, 4, D_OUT),
            "a2": _rand(rng, D_IN, 4), "b2": _rand(rng, 4, D_OUT)}
    _both(lambda x_, w_, p_: jp.loha_linear(x_, w_, p_, scale),
          lambda x_, w_, p_: tp.loha_linear(x_, w_, p_, scale),
          x, w, loha, cot)
    lokr = {"c": _rand(rng, 4, 3), "a": _rand(rng, D_IN // 4, 2),
            "b": _rand(rng, 2, D_OUT // 3)}
    _both(lambda x_, w_, p_: jp.lokr_linear(x_, w_, p_, scale),
          lambda x_, w_, p_: tp.lokr_linear(x_, w_, p_, scale),
          x, w, lokr, cot)
    vera = {"frozen_a": _rand(rng, D_IN, 6), "frozen_b": _rand(rng, 6, D_OUT),
            "d": _rand(rng, 6), "b": _rand(rng, D_OUT)}
    _both(jp.vera_linear, tp.vera_linear, x, w, vera, cot)


def test_adalora_delta_reg_and_importance_match_jax():
    rng, x, w, cot = _data(4)
    p = {"p": _rand(rng, D_IN, 6), "lam": _rand(rng, 6),
         "q": _rand(rng, 6, D_OUT),
         "mask": np.array([1, 0, 1, 1, 0, 1], np.float32)}
    _both(jp.adalora_linear, tp.adalora_linear, x, w, p, cot)
    jr = jax.value_and_grad(jp.adalora_orth_reg)(jax.tree.map(jnp.asarray, p))
    tpar = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    reg = tp.adalora_orth_reg(tpar)
    np.testing.assert_allclose(float(reg.detach()), float(jr[0]), rtol=1e-5)
    for k, g in zip(("p", "q"), torch.autograd.grad(reg, (tpar["p"],
                                                         tpar["q"]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(jr[1][k]), **GRAD)
    grads = {"lam": _rand(rng, 6)}
    np.testing.assert_allclose(
        tp.adalora_importance(params_from_numpy(p, "cpu"),
                              params_from_numpy(grads, "cpu")).numpy(),
        np.asarray(jp.adalora_importance(p, grads)), **TOL)


@pytest.mark.parametrize("budget", [1, 4, 5, 9, 20])
def test_adalora_allocate_matches_jax_with_ties(budget):
    """Global top-k by ``>=`` the k-th largest: values tied with it are all
    kept, in both packages."""
    imps = [np.array([0.5, 0.1, 0.3], np.float32),
            np.array([0.3, 0.9], np.float32),
            np.array([0.3, 0.05, 0.7, 0.1], np.float32)]
    want = jp.adalora_allocate([jnp.asarray(i) for i in imps], budget)
    got = tp.adalora_allocate([torch.tensor(i) for i in imps], budget)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert g.dtype == torch.float32


def test_adalora_tree_walk_taps_and_mask_update_match_jax():
    rng = np.random.default_rng(5)

    def node(r):
        return {"p": _rand(rng, D_IN, r), "lam": _rand(rng, r),
                "q": _rand(rng, r, D_OUT), "mask": np.ones(r, np.float32)}

    tree = {"layers": {"q": node(4), "v": node(3)}, "head": node(2),
            "other": {"w": _rand(rng, 3)}}
    grads = jax.tree.map(lambda a: _rand(rng, *a.shape), tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_numpy(tree, "cpu")
    # jax.tree.map sorts dict keys; the port keeps the tree's order
    assert sorted(tp.adalora_tree_paths(ttree)) == \
        sorted(jp.adalora_tree_paths(jtree))
    jtaps = jp.adalora_grad_taps(jax.tree.map(jnp.asarray, grads))
    ttaps = tp.adalora_grad_taps(params_from_numpy(grads, "cpu"))
    assert set(ttaps) == set(jtaps) == {"layers/q", "layers/v", "head"}
    for k in jtaps:
        np.testing.assert_array_equal(ttaps[k].numpy(), np.asarray(jtaps[k]))
    want = jp.adalora_update_masks(jtree, jtaps, 4)
    got = tp.adalora_update_masks(ttree, ttaps, 4)
    for path in tp.adalora_tree_paths(got):
        np.testing.assert_array_equal(tp._get(got, path)["mask"].numpy(),
                                      np.asarray(jp._get(want, path)["mask"]))
        # the caller's tree keeps its masks
        assert bool((tp._get(ttree, path)["mask"] == 1).all())
    assert float(sum(tp._get(got, p)["mask"].sum()
                     for p in tp.adalora_tree_paths(got))) == 4.0
    assert got["other"]["w"] is ttree["other"]["w"]


@pytest.mark.parametrize("n_splits", [1, 2])
def test_poly_matches_jax_eval_and_forced_noise(n_splits):
    """Eval mixing, then training mixing with JAX's own uniform draws fed
    as ``noise``: outputs and gradients in A, B and the router."""
    rng, x, w, cot = _data(6, batch=(3, 5))
    js = jp.PolySpec(n_tasks=4, n_skills=3, n_splits=n_splits, rank=2)
    ts = tp.PolySpec(n_tasks=4, n_skills=3, n_splits=n_splits, rank=2)
    di, do = D_IN // n_splits, D_OUT // n_splits
    p = {"a": _rand(rng, n_splits, 3, di, 2), "b": _rand(rng, n_splits, 3, 2,
                                                          do),
         "router": _rand(rng, 4, n_splits * 3)}
    tasks = np.array([0, 3, 1])
    key = jax.random.key(9)
    noise = np.asarray(jax.random.uniform(key, (3, n_splits, 3),
                                          minval=1e-6, maxval=1.0 - 1e-6))
    for jrng, tnoise in ((None, None), (key, torch.tensor(noise))):
        _both(lambda x_, w_, p_: jp.poly_linear(x_, w_, p_,
                                                jnp.asarray(tasks), js, jrng),
              lambda x_, w_, p_: tp.poly_linear(x_, w_, p_,
                                                torch.tensor(tasks), ts,
                                                noise=tnoise),
              x, w, p, cot)
    mw = tp.poly_mixing_weights(torch.tensor(p["router"]),
                                torch.tensor(tasks), ts,
                                generator=torch.Generator().manual_seed(0))
    assert mw.shape == (3, n_splits, 3)
    np.testing.assert_allclose(mw.sum(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_inits_shapes_ranges_and_zeros():
    g = torch.Generator().manual_seed(0)
    dev = dict(device="cpu")
    lora = tp.init_lora(g, D_IN, D_OUT, tp.LoraSpec(rank=4), **dev)
    assert lora["a"].shape == (D_IN, 4) and not lora["b"].any()
    assert float(lora["a"].abs().max()) <= 1 / np.sqrt(D_IN)
    assert bool((tp.init_ia3(D_OUT, **dev)["scale"] == 1).all())
    assert tp.init_oft(D_IN, 4, **dev)["q"].shape == (4, 4, 4)
    loha = tp.init_loha(g, D_IN, D_OUT, 4, **dev)
    assert not loha["b1"].any() and loha["b2"].shape == (4, D_OUT)
    lokr = tp.init_lokr(g, D_IN, D_OUT, 4, 3, 2, **dev)
    assert lokr["c"].shape == (4, 3) and lokr["a"].shape == (4, 2)
    assert not tp.lokr_delta(lokr).any()  # zero B: a no-op at the start
    vera = tp.init_vera(g, D_IN, D_OUT, 6, **dev)
    assert not vera["b"].any() and bool((vera["d"] == 0.1).all())
    ada = tp.init_adalora(g, D_IN, D_OUT, tp.AdaLoraSpec(init_rank=6), **dev)
    assert not ada["lam"].any() and bool((ada["mask"] == 1).all())
    poly = tp.init_poly(g, D_IN, D_OUT, tp.PolySpec(n_tasks=4, n_splits=2),
                        **dev)
    assert poly["a"].shape == (2, 4, D_IN // 2, 4) and not poly["b"].any()
    assert float(poly["router"].abs().max()) <= 1e-3
    with pytest.raises(ValueError):
        tp.init_lokr(g, D_IN, D_OUT, 5, 3, **dev)
    with pytest.raises(ValueError):
        tp.init_oft(10, 4, **dev)


def test_params_from_numpy_carries_every_tuner_tree():
    """Every JAX-initialised tuner tree converts leaf by leaf, with the same
    keys, shapes, dtypes and values."""
    k = jax.random.key(0)
    trees = {
        "lora": jp.init_lora(k, D_IN, D_OUT, jp.LoraSpec(rank=4)),
        "ia3": jp.init_ia3(D_OUT),
        "boft": jp.init_boft(D_IN, jp.BoftSpec(4, 2)),
        "oft": jp.init_oft(D_IN, 4),
        "loha": jp.init_loha(k, D_IN, D_OUT, 4),
        "lokr": jp.init_lokr(k, D_IN, D_OUT, 4, 3, 2),
        "vera": jp.init_vera(k, D_IN, D_OUT, 6),
        "adalora": jp.init_adalora(k, D_IN, D_OUT, jp.AdaLoraSpec()),
        "poly": jp.init_poly(k, D_IN, D_OUT, jp.PolySpec(n_tasks=3,
                                                         n_splits=2)),
    }
    got = params_from_numpy(_np(trees), "cpu")
    for name, tree in trees.items():
        assert set(got[name]) == set(tree), name
        for leaf, arr in tree.items():
            t = got[name][leaf]
            assert t.dtype == torch.float32 and tuple(t.shape) == arr.shape
            np.testing.assert_array_equal(t.numpy(), np.asarray(arr))
