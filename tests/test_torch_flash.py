"""Port parity: flash forward (plain version), eager attention and the
kernel wrapper's contract, against the JAX package on the CPU in fp32.

The JAX flash forward runs in Pallas interpret mode, as its own tests run
it.  Only valid query rows are compared: a row whose keys are all masked
has an unspecified output (the blocked kernels average V over the blocks
that ran, the plain version over all keys).  Tolerance 2e-5: fp32 with a
different summation order (blocked online softmax vs one pass)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.ops import attention as jattn
from moka_tpu.ops.flash_attention import _flash_fwd_res, flash_mha as j_flash
from moka_tpu_torch.ops import attention as tattn
from moka_tpu_torch.ops.flash_attention import (flash_fwd, flash_fwd_plain,
                                                flash_mha)

TOL = dict(rtol=2e-5, atol=2e-5)


def _data(b=2, L=16, S=16, H=4, KH=2, hd=8, pads=(3, 0), seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, L, H, hd)).astype(np.float32)
    k = rng.standard_normal((b, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((b, S, KH, hd)).astype(np.float32)
    mask = np.ones((b, S), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    return q, k, v, mask


def _valid_rows(mask, L, q_offset, causal=True):
    S = mask.shape[1]
    qpos = np.arange(L)[:, None] + q_offset
    vis = (mask[:, None, :] > 0)
    if causal:
        vis = vis & (qpos >= np.arange(S)[None, :])[None]
    return vis.any(-1)  # (b, L)


def _cmp_rows(got, want, rows, **kw):
    """got/want (b, L, H, hd) compared on valid rows only."""
    r = rows[:, :, None, None]
    np.testing.assert_allclose(np.asarray(got) * r, np.asarray(want) * r,
                               **kw)


@pytest.mark.parametrize("case", [
    dict(),                                         # padding + GQA 4:2
    dict(H=4, KH=4, pads=(0, 5)),                   # MHA
    dict(L=8, S=24, q_offset=16, pads=(2, 0)),      # prefill into a cache
    dict(causal=False, pads=(0, 7)),                # non-causal
])
def test_flash_plain_matches_jax_kernel(case):
    case = dict(case)
    q_offset = case.pop("q_offset", 0)
    causal = case.pop("causal", True)
    q, k, v, mask = _data(**case)
    hd = q.shape[-1]
    out_j, lse_j = _flash_fwd_res(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), jnp.asarray(mask), q_offset,
        causal, 1.0 / math.sqrt(hd), 8, 8, True)
    out_t, lse_t = flash_fwd_plain(*map(torch.from_numpy, (q, k, v, mask)),
                                   q_offset=q_offset, causal=causal)
    rows = _valid_rows(mask, q.shape[1], q_offset, causal)
    _cmp_rows(out_t.numpy(), np.asarray(out_j).transpose(0, 2, 1, 3), rows,
              **TOL)
    lse_rows = np.asarray(lse_j) * rows[:, None, :]
    np.testing.assert_allclose(lse_t.numpy() * rows[:, None, :], lse_rows,
                               **TOL)


@pytest.mark.parametrize("L,S,q_offset", [(13, 13, 0), (5, 21, 16)])
def test_flash_mha_ragged_matches_jax_and_eager(L, S, q_offset):
    """Ragged lengths (the JAX wrapper pads to its blocks; the port masks
    the ragged edge itself) and the eager path on the same inputs."""
    q, k, v, mask = _data(L=L, S=S, pads=(2, 0), seed=1)
    want = j_flash(*map(jnp.asarray, (q, k, v, mask)), q_offset=q_offset,
                   block_q=8, block_k=8, interpret=True)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    got = flash_mha(tq, tk, tv, tmask, q_offset=q_offset)
    eager = tattn.mha(tq, tk, tv, tattn.causal_bias(tmask, L, S, q_offset))
    rows = _valid_rows(mask, L, q_offset)
    _cmp_rows(got.numpy(), np.asarray(want), rows, **TOL)
    _cmp_rows(got.numpy(), eager.numpy(), rows, **TOL)


def test_eager_attention_matches_jax():
    q, k, v, mask = _data(L=6, S=12, seed=2)
    bias_j = jattn.causal_bias(jnp.asarray(mask), 6, 12, q_offset=6)
    bias_t = tattn.causal_bias(torch.from_numpy(mask), 6, 12, q_offset=6)
    np.testing.assert_array_equal(bias_t.numpy(), np.asarray(bias_j))
    want = jattn.mha(*map(jnp.asarray, (q, k, v)), bias_j)
    got = tattn.mha(*map(torch.from_numpy, (q, k, v)), bias_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_bf16_prescale_rounds_in_q_dtype():
    """q * (scale*log2e) is rounded to bf16 before the scores, as in the
    JAX wrapper; the bf16 plain version stays within bf16 rounding of the
    fp32 one on valid rows."""
    q, k, v, mask = _data(seed=3)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    out32, lse32 = flash_fwd_plain(*ts, torch.from_numpy(mask))
    out16, lse16 = flash_fwd_plain(*(t.bfloat16() for t in ts),
                                   torch.from_numpy(mask))
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    rows = _valid_rows(mask, q.shape[1], 0)
    _cmp_rows(out16.float().numpy(), out32.numpy(), rows, atol=5e-2)


def test_flash_wrapper_contract():
    """CPU tensors take the plain version and never count a launch; a
    query that needs grad raises (backward kernels not ported)."""
    q, k, v, mask = map(torch.from_numpy, _data(seed=4))
    before = flash_fwd.launches
    out, lse = flash_fwd(q, k, v, mask)
    ref, ref_lse = flash_fwd_plain(q, k, v, mask)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert flash_fwd.launches == before
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_fwd(q.requires_grad_(True), k, v, mask)
