"""Port parity: ``moka_tpu_torch/ops/quant.py`` against
``moka_tpu/ops/quant.py`` on the CPU, same numpy inputs.

Tolerances: codes, scales, unpacking and dequantization bit-exact (the
same fp32 operations in the same order, round half to even on both
sides); the a8 forward bit-exact (an exact int32 product, then ``(acc *
sx) * sw`` in fp32 as JAX); the int8 weight-only product and the int8 dX
products exact; an int4 product in fp32 to rtol 1e-5 (JAX sums the two
nibble halves as two fp32 products, the port one product over the whole
contraction: only the summation order differs); the save-set roundtrips
bit-exact, NaN included (fp8 past +-464, where ``ml_dtypes`` gives NaN).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg
from moka_tpu.models import llama as jllama
from moka_tpu.ops import quant as jq
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.ops import quant as tq

BITS = {"quantize_int8": 8, "quantize_int4": 4}


def _w(shape, seed=0):
    """Random weights with an all-zero output column (scale 1, codes 0)."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0
    return w


def _same(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fn", sorted(BITS))
@pytest.mark.parametrize("shape", [(64, 24), (3, 32, 40)])
def test_codes_scales_and_dequantize_bit_exact(fn, shape):
    w = _w(shape)
    jw = getattr(jq, fn)(jnp.asarray(w))
    tw = getattr(tq, fn)(torch.from_numpy(w))
    assert set(tw) == set(jw)
    for k in jw:
        converted = params_from_numpy(np.asarray(jw[k]), "cpu")
        assert tw[k].dtype == converted.dtype
        _same(jw[k], tw[k])
    assert (tw["scale"][..., 3] == 1).all()
    if "w_i4" in jw:
        for a, b in zip(jq.unpack_int4(jw["w_i4"]),
                        tq.unpack_int4(tw["w_i4"])):
            _same(a, b)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        _same(jq.dequantize(jw, dt).astype(jnp.float32),
              tq.dequantize(tw, tdt).float())
    assert tq.is_quantized(tw) and not tq.is_quantized(torch.zeros(2))


def _x(shape=(2, 9, 64), seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, 2] = 0  # an all-zero token: scale 1, codes 0
    return x


@pytest.mark.parametrize("fn,dtype", [
    *(pytest.param(fn, "float32", id=fn) for fn in sorted(BITS)),
    *(pytest.param(fn, "bfloat16", id=f"{fn}-bf16") for fn in sorted(BITS))])
def test_qmatmul_matches_jax(fn, dtype):
    """fp32 x at the module's shapes; bf16 x at (4, 64, 1024) x (1024,
    256), where an int4 product rounded to bf16 before its scale (one
    rounding more than JAX's fp32 accumulator) moved a quarter of the
    outputs: at most 0.1% of outputs may differ, each by one bf16 ulp."""
    if dtype == "float32":
        w, x = _w((64, 24)), _x()
    else:
        w, x = _w((1024, 256)), _x((4, 64, 1024))
    jw, tw = getattr(jq, fn)(jnp.asarray(w)), getattr(tq, fn)(
        torch.from_numpy(w))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jq.qmatmul(jnp.asarray(x, jdt), jw).astype(
        jnp.float32))
    got = tq.qmatmul(torch.from_numpy(x).to(tdt), tw)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "bfloat16":
        differ = got != want
        assert differ.mean() <= 1e-3, differ.mean()
        ulp = np.abs(want[differ]) * 2.0 ** -7  # one ulp at most
        assert (np.abs(got - want)[differ] <= ulp).all()
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if fn == "quantize_int8":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bwd_a8", [False, True])
@pytest.mark.parametrize("fn", sorted(BITS))
def test_qmatmul_a8_forward_and_dx_match_jax(fn, bwd_a8):
    """fp32 output and dX for a fixed cotangent (with an all-zero row)."""
    w, x = _w((64, 24)), _x()
    g = np.random.default_rng(2).standard_normal((2, 9, 24)).astype(
        np.float32)
    g[1, 4] = 0
    jw, tw = getattr(jq, fn)(jnp.asarray(w)), getattr(tq, fn)(
        torch.from_numpy(w))
    want, vjp = jax.vjp(lambda v: jq.qmatmul_a8(
        v, jw, bwd_a8=bwd_a8, out_dtype=jnp.float32), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tq.qmatmul_a8(tx, tw, bwd_a8=bwd_a8, out_dtype=torch.float32)
    (tdx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    _same(want, got.detach())
    if bwd_a8 or fn == "quantize_int8":
        _same(jdx, tdx)
    else:
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-5,
                                   atol=1e-6)
    assert (tdx[1, 4] == 0).all() and (got[0, 2] == 0).all()


def test_qmatmul_a8_bf16_and_few_rows():
    """bf16 x (out in bf16, dX in bf16), and fewer than 17 rows (the port
    pads rows for ``torch._int_mm``)."""
    w = _w((64, 40))
    x = _x((1, 3, 64)).astype(jnp.bfloat16)
    jw, tw = jq.quantize_int4(jnp.asarray(w)), tq.quantize_int4(
        torch.from_numpy(w))
    want, vjp = jax.vjp(lambda v: jq.qmatmul_a8(v, jw, bwd_a8=True),
                        jnp.asarray(x))
    g = np.ones((1, 3, 40), np.float32)
    (jdx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = params_from_numpy(x, "cpu").requires_grad_(True)
    got = tq.qmatmul_a8(tx, tw, bwd_a8=True)
    (tdx,) = torch.autograd.grad(got, tx, torch.ones_like(got))
    assert got.dtype == tdx.dtype == torch.bfloat16
    _same(want.astype(jnp.float32), got.detach().float())
    _same(jdx.astype(jnp.float32), tdx.float())


@pytest.mark.parametrize("which", ["q8_roundtrip", "fp8_roundtrip"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_roundtrips_values_and_straight_through_gradient(which, dtype):
    """Values bit-exact (NaN where e4m3fn overflows, as ``ml_dtypes``),
    the gradient the cotangent itself."""
    y = (np.random.default_rng(3).standard_normal((2, 5, 16)) * 100).astype(
        np.float32)
    y[0, 0, :4] = [500.0, -470.0, 464.0, 449.0]  # past, past, tie, in range
    y[1, 1] = 0
    jy = jnp.asarray(y, dtype)
    want, vjp = jax.vjp(lambda v: getattr(jq, which)("proj_q", v), jy)
    ty = params_from_numpy(np.asarray(jy), "cpu").requires_grad_(True)
    got = getattr(tq, which)(ty)
    g = torch.arange(got.numel(), dtype=got.dtype).reshape(got.shape)
    (tg,) = torch.autograd.grad(got, ty, g)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(tg, g)
    (jg,) = vjp(jnp.asarray(g.float().numpy(), dtype))
    np.testing.assert_array_equal(np.asarray(jg.astype(jnp.float32)),
                                  g.float().numpy())
    if which == "fp8_roundtrip":
        assert torch.isnan(got[0, 0, :2]).all() and got[0, 0, 2] == 448


@pytest.mark.parametrize("head_bits", [8, 4])
def test_quantize_llama_base_matches_jax(head_bits):
    cfg = JCfg.tiny()
    base = jllama.init_llama_params(jax.random.key(0), cfg,
                                    dtype=jnp.float32)
    want = jq.quantize_llama_base(base, bits=4, head_bits=head_bits)
    got = tq.quantize_llama_base(
        params_from_numpy(jax.tree.map(np.asarray, base), "cpu"), bits=4,
        head_bits=head_bits)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert tq.quantized_bytes(got) == jq.quantized_bytes(want)
    for path, leaf in flat_w:
        node = got
        for p in path:
            node = node[p.key]
        _same(leaf, node)


def test_init_llama_params_quantized_shapes():
    """Shapes and dtypes as JAX's (values come from another generator)."""
    cfg = LlamaConfig.tiny()
    got = tq.init_llama_params_quantized(torch.Generator().manual_seed(0),
                                         cfg, bits=4, head_bits=8,
                                         device="cpu")
    want = jq.init_llama_params_quantized(jax.random.key(0), JCfg.tiny(),
                                          bits=4, head_bits=8)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[1] == str(leaf.dtype), path
    scale = got["layers"]["q"]["scale"]
    assert (scale > 0).all() and float(scale.mean()) < 0.02


def test_a8_operands_kept_for_the_head_only():
    """A weight that is a tensor of its own (the lm_head) keeps its
    column-major int8 operands, built once; a layer's weight, a view into
    a layer-stacked base, keeps nothing (its operands would hold an int8
    copy of the base through the backward)."""
    w = tq.quantize_int8(torch.from_numpy(_w((64, 203))))
    stacked = {k: torch.stack([v, v]) for k, v in w.items()}
    layer = {k: v[0] for k, v in stacked.items()}
    x = torch.from_numpy(_x()).requires_grad_(True)
    y = tq.qmatmul_a8(x, layer, bwd_a8=True, out_dtype=torch.float32)
    y.sum().backward()
    assert tq.operand_cache(layer["w_i8"]) == {}
    assert tq.operand_cache(stacked["w_i8"]) == {}
    y = tq.qmatmul_a8(x, w, bwd_a8=True, out_dtype=torch.float32)
    y.sum().backward()
    kept = tq.operand_cache(w["w_i8"])
    assert set(kept) == {("a8", False), ("a8", True)}
    fwd = kept[("a8", False)]
    assert fwd.shape == (64, 208) and fwd.stride() == (1, 64)  # n padded
    assert torch.equal(fwd[:, :203], w["w_i8"])
