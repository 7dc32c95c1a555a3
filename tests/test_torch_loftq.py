"""Port parity: LoftQ (``adapters/loftq.py``) against the JAX package.

The port keeps the JAX package's numpy math, so the codebooks, block
codes, dequantized weights and integer codes are exact.  The low-rank
factors come from an SVD whose singular vectors are defined up to sign,
so factors are compared through their products A·B (to 1e-6 of the
largest |A·B|: the same numpy SVD on the same input; only the port's
torch quantization stands in for JAX's, and its codes are exact).
"""

import numpy as np
import jax
import pytest
import torch

from moka_tpu.adapters import loftq as jloftq
from moka_tpu.core.config import LlamaConfig as JCfg
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu_torch.adapters import loftq as tloftq
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops.moka import MokaSpec

PRODUCT_TOL = 1e-6  # of max|A·B|


@pytest.fixture(autouse=True)
def one_blas_thread():
    """Small SVDs: BLAS threads would only spin against the other test
    workers' (as in ``tests/test_torch_cli.py::one_thread``)."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(limits=1):
        yield


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close_products(a, b, ja, jb):
    p, jp = np.asarray(a) @ np.asarray(b), np.asarray(ja) @ np.asarray(jb)
    np.testing.assert_allclose(p, jp, rtol=0,
                               atol=PRODUCT_TOL * np.abs(jp).max())


@pytest.mark.parametrize("num_bits", [2, 4, 8])
@pytest.mark.parametrize("method", ["normal", "uniform"])
def test_nf_codebook_and_blocks(num_bits, method):
    np.testing.assert_array_equal(
        tloftq.nf_lookup(num_bits, method=method),
        jloftq.nf_lookup(num_bits, method=method))
    w = _w((32, 64), num_bits)
    idx, bmax = tloftq.nf_quantize_block(w, num_bits, 64, method)
    jidx, jbmax = jloftq.nf_quantize_block(w, num_bits, 64, method)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(bmax, jbmax)
    np.testing.assert_array_equal(
        tloftq.nf_dequantize_block(idx, bmax, w.shape, num_bits, method),
        jloftq.nf_dequantize_block(jidx, jbmax, w.shape, num_bits, method))


def test_low_rank_decomposition():
    w = _w((48, 40), 1)
    _close_products(*tloftq.low_rank_decomposition(w, 6),
                    *jloftq.low_rank_decomposition(w, 6))


@pytest.mark.parametrize("method,num_bits,num_iter",
                         [("nf", 4, 1), ("nf", 2, 3), ("uniform", 4, 2),
                          ("linear", 4, 1), ("linear", 8, 3),
                          ("linear", 4, 2)])
def test_loftq_init(method, num_bits, num_iter):
    w = _w((64, 48), 2)
    q, a, b = tloftq.loftq_init(w, num_bits=num_bits, rank=4,
                                num_iter=num_iter, method=method, scale=2.0)
    jq, ja, jb = jloftq.loftq_init(w, num_bits=num_bits, rank=4,
                                   num_iter=num_iter, method=method,
                                   scale=2.0)
    if method == "linear":
        assert q.keys() == jq.keys()
        for k in jq:
            assert q[k].dtype == jq[k].dtype
            np.testing.assert_array_equal(q[k], jq[k])
    else:
        np.testing.assert_array_equal(q, jq)
    _close_products(a, b, ja, jb)


@pytest.mark.parametrize("num_bits,num_iter", [(4, 2), (8, 1)])
def test_loftq_init_moka_adapters(num_bits, num_iter):
    cfg, jcfg = LlamaConfig.tiny(), JCfg.tiny()
    spec, jspec = MokaSpec.avt(rank=4), JSpec.avt(rank=4)
    base = tllama.init_llama_params(torch.Generator().manual_seed(3), cfg,
                                    device="cpu")  # bf16, as the CLIs pass
    jbase = jax.tree.map(lambda t: t.float().numpy(), base)
    targets = ("q", "v", "down")
    qtree, ad = tloftq.loftq_init_moka_adapters(base, cfg, spec, num_bits,
                                                num_iter, targets)
    jqtree, jad = jloftq.loftq_init_moka_adapters(jbase, jcfg, jspec,
                                                  num_bits, num_iter,
                                                  targets)
    for name, leaf in jqtree["layers"].items():
        got = qtree["layers"][name]
        if isinstance(leaf, dict):
            assert got.keys() == leaf.keys()
            for k in leaf:
                assert str(got[k].dtype).removeprefix("torch.") == \
                    np.asarray(leaf[k]).dtype.name
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(leaf[k]))
        else:
            assert got is base["layers"][name]
    assert qtree["embed"] is base["embed"]
    assert set(ad["layers"]) == set(jad["layers"]) == set(targets)
    for name in targets:
        a, b = ad["layers"][name]["a"], ad["layers"][name]["b"]
        ja = np.asarray(jad["layers"][name]["a"])
        jb = np.asarray(jad["layers"][name]["b"])
        assert a.dtype == torch.float32 and tuple(a.shape) == ja.shape
        assert tuple(b.shape) == jb.shape
        for layer in range(cfg.n_layers):
            for m in range(spec.num_modalities):
                _close_products(a[layer, m].numpy(), b[layer].numpy(),
                                ja[layer, m], jb[layer])


def test_loftq_tree_trains_in_the_port():
    """The LoftQ base and adapters feed the port's forward directly: its
    W ≈ Q + pre_scale·A·B start is closer to the bf16 base's logits than
    the plain quantized base with zero B."""
    from moka_tpu_torch.ops.quant import quantize_llama_base
    cfg = LlamaConfig.tiny()
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    base = tllama.init_llama_params(torch.Generator().manual_seed(4), cfg,
                                    device="cpu", dtype=torch.float32)
    qtree, ad = tloftq.loftq_init_moka_adapters(base, cfg, spec, 4, 3)
    toks = torch.randint(4, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    ref, _ = tllama.forward(base, cfg, tokens=toks)
    mod = torch.zeros(3, 2, 12)
    mod[0] = 1
    masks = tllama.MaskBundle(mod, torch.zeros(2, 12))
    got, _ = tllama.forward(qtree, cfg, adapters=ad, spec=spec, tokens=toks,
                            masks=masks)
    plain, _ = tllama.forward(quantize_llama_base(base, bits=4), cfg,
                              tokens=toks)
    assert (got - ref).norm() < (plain - ref).norm()
