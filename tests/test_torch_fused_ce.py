"""Port parity: the fused lm_head + CE (``moka_tpu_torch/ops/fused_ce.py``,
TPU kernels 8-9) and the quantized heads of ``chunked_cross_entropy``
against the JAX package on the CPU, same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode with small tiles
(ragged rows and vocab: row and vocab padding both exercised); the port's
wrappers take their plain versions for CPU tensors.  Tolerances: the loss
to rtol 1e-5 and dx to 1e-3 of max|dx| + rtol 1e-3 (both round x and the
softmax term p to bf16 at the same points; the fp32 sums run in another
order, which can move a bf16 rounding of p: one bf16 ulp is 2^-8
relative).  The chunked a8 head: loss rtol 1e-5, dX rtol 1e-4 (exact
int32 products; fp32 softmax sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.models import llama as jllama
from moka_tpu.ops import quant as jq
from moka_tpu.ops.fused_ce import fused_ce_loss as j_fused_ce_loss
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import fused_ce as tce
from moka_tpu_torch.ops import quant as tq

DX = dict(rtol=1e-3)


def _case(rows, vocab, d=64, seed=0, ignore_every=7):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, d)).astype(np.float32)
    w = rng.standard_normal((d, vocab)).astype(np.float32)
    t = rng.integers(0, vocab, rows).astype(np.int32)
    if ignore_every:
        t[::ignore_every] = -100
    return h, w, t


def _both(h, w, t, block_r=16, block_v=64):
    """(JAX loss, JAX dh) in interpret mode and (port loss, port dh)."""
    jw = jq.quantize_int8(jnp.asarray(w))
    want, jg = jax.value_and_grad(lambda x: j_fused_ce_loss(
        x, jw, jnp.asarray(t), block_r=block_r, block_v=block_v,
        interpret=True))(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tce.fused_ce_loss(th, params_from_numpy(
        jax.tree.map(np.asarray, jw), "cpu"), torch.from_numpy(t))
    (tg,) = torch.autograd.grad(got, th)
    return (float(want), np.asarray(jg)), (float(got.detach()), tg.numpy())


def _close_dx(got, want):
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(),
                               **DX)


@pytest.mark.parametrize("rows,vocab", [(50, 203), (64, 256)])
def test_fused_ce_matches_jax_interpret(rows, vocab):
    (want, jg), (got, tg) = _both(*_case(rows, vocab))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close_dx(tg, jg)
    assert (tg[::7] == 0).all()  # ignored rows carry no gradient


def test_fused_ce_all_rows_ignored():
    (want, jg), (got, tg) = _both(*_case(16, 64, ignore_every=1),
                                  block_v=32)
    assert want == got == 0.0
    assert (tg == 0).all() and (jg == 0).all()


def test_fused_ce_kernel_contract_plain_versions():
    """nll and lse per row against the logits written out, and dx against
    its definition (cotangent 0 on some rows)."""
    h, w, t = _case(20, 45)
    hq = tq.quantize_int8(torch.from_numpy(w))
    x = torch.from_numpy(h).bfloat16()
    scale = hq["scale"].reshape(-1)
    tt = torch.from_numpy(t)
    nll, lse = tce.fused_ce_fwd(x, hq["w_i8"], scale, tt)
    logits = x.double() @ tq.dequantize(hq, torch.float32).double()
    ref_lse = torch.logsumexp(logits, -1)
    valid = tt >= 0
    ref_nll = ref_lse - torch.where(
        valid, logits.gather(1, tt.clamp(min=0).long()[:, None])[:, 0], 0.0)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-6)
    np.testing.assert_allclose(nll.numpy(), ref_nll.numpy(), rtol=1e-5,
                               atol=1e-5)
    g = torch.linspace(0, 1, 20)
    dx = tce.fused_ce_bwd(x, hq["w_i8"], scale, tt, lse, g)
    p = torch.softmax(logits, -1)
    p[valid, tt[valid].long()] -= 1
    ref = (p * g[:, None].double()) @ tq.dequantize(
        hq, torch.float32).double().t()
    assert dx.dtype == torch.bfloat16 and (dx[0] == 0).all()
    # p and dx are rounded to bf16 (2^-8 relative each) against fp64
    np.testing.assert_allclose(dx.float().numpy(), ref.numpy(), rtol=1e-2,
                               atol=1e-2 * float(ref.abs().max()))


def test_fused_ce_wrappers_reject_bad_inputs():
    h, w, t = _case(8, 32)
    hq = tq.quantize_int8(torch.from_numpy(w))
    x = torch.from_numpy(h).bfloat16()
    wq, s, tt = hq["w_i8"], hq["scale"].reshape(-1), torch.from_numpy(t)
    with pytest.raises(TypeError, match="bf16 x and an int8 head"):
        tce.fused_ce_fwd(x.float(), wq, s, tt)
    with pytest.raises(TypeError, match="bf16 x and an int8 head"):
        tce.fused_ce_fwd(x, wq.to(torch.uint8), s, tt)
    with pytest.raises(ValueError, match="want \\(N, d\\) and \\(d, V\\)"):
        tce.fused_ce_fwd(x[:, :10], wq, s, tt)
    with pytest.raises(ValueError, match="scale"):
        tce.fused_ce_fwd(x, wq, s[:-1], tt)
    with pytest.raises(ValueError, match="targets"):
        tce.fused_ce_fwd(x, wq, s, tt[:-1])
    with pytest.raises(ValueError, match="per-row"):
        tce.fused_ce_bwd(x, wq, s, tt, torch.zeros(8), torch.zeros(7))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no fused CE for device meta"):
        tce.fused_ce_fwd(torch.empty((8, 64), dtype=torch.bfloat16, **meta),
                         torch.empty((64, 32), dtype=torch.int8, **meta),
                         torch.empty(32, **meta),
                         torch.empty(8, dtype=torch.int32, **meta))
    assert tce.fused_ce_fwd.launches == tce.fused_ce_bwd.launches == 0


def test_padded_head_is_built_once():
    _, w, _ = _case(4, 203)
    hq = tq.quantize_int8(torch.from_numpy(w))
    wp, sp = tce.padded_head(hq["w_i8"], hq["scale"])
    assert wp.shape == (64, 512) and sp.shape == (512,)
    assert torch.equal(wp[:, :203], hq["w_i8"]) and (wp[:, 203:] == 0).all()
    assert tce.padded_head(hq["w_i8"], hq["scale"])[0] is wp


def _head_case(bits, seed=5):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((3, 10, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 203)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 203, (3, 10)).astype(np.int32)
    labels[1, :6] = -100
    jw = {8: jq.quantize_int8, 4: jq.quantize_int4}[bits](jnp.asarray(w))
    return h, jw, labels


@pytest.mark.parametrize("a8,bits,chunk", [(False, 8, 4), (True, 8, 64),
                                           ("full", 8, 4), ("full", 4, 64),
                                           (False, 4, 4)])
def test_chunked_ce_quantized_heads_match_jax(a8, bits, chunk):
    """Route A's head: the chunked CE on an int8 or int4 head, weight-only
    or through the a8 product (``a8`` True / "full"), value and dX."""
    h, jw, labels = _head_case(bits)
    want, jg = jax.value_and_grad(lambda x: jllama.chunked_cross_entropy(
        x, jw, jnp.asarray(labels), chunk=chunk, a8=a8))(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tllama.chunked_cross_entropy(
        th, params_from_numpy(jax.tree.map(np.asarray, jw), "cpu"),
        torch.from_numpy(labels), chunk=chunk, a8=a8)
    (tg,) = torch.autograd.grad(got, th)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)


def test_chunked_ce_pallas_ce_matches_jax():
    """Route B's head: ``chunked_cross_entropy(pallas_ce=True)`` against
    JAX's (its Pallas kernels in interpret mode on the CPU)."""
    h, jw, labels = _head_case(8)
    want, jg = jax.value_and_grad(lambda x: jllama.chunked_cross_entropy(
        x, jw, jnp.asarray(labels), pallas_ce=True))(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tllama.chunked_cross_entropy(
        th, params_from_numpy(jax.tree.map(np.asarray, jw), "cpu"),
        torch.from_numpy(labels), pallas_ce=True)
    (tg,) = torch.autograd.grad(got, th)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close_dx(tg.numpy(), np.asarray(jg))
