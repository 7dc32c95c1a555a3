"""Port parity: flash attention forward and backward (plain versions),
eager attention and the kernel wrappers' contract, against the JAX package
on the CPU in fp32.

The JAX flash kernels run in Pallas interpret mode, as its own tests run
them.  Only valid query rows of the forward are compared: a row whose keys
are all masked has an unspecified output (the blocked kernels average V
over the blocks that ran, the plain version over all keys); its gradients
are zero on both sides.  Tolerances: 2e-5 for the forward, fp32 with a
different summation order (blocked online softmax vs one pass); 1e-4
relative + 1e-5 absolute for gradients, which add one more blocked sum
(dk, dv over query blocks) and the GQA group sum."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.ops import attention as jattn
from moka_tpu.ops.flash_attention import (_flash_bwd_dkv, _flash_bwd_dq,
                                          _flash_bwd_fused, _flash_fwd_res,
                                          flash_mha as j_flash)
from moka_tpu_torch.ops import attention as tattn
from moka_tpu_torch.ops import flash_attention as tflash
from moka_tpu_torch.ops.flash_attention import (flash_fwd, flash_fwd_plain,
                                                flash_mha)

TOL = dict(rtol=2e-5, atol=2e-5)
GTOL = dict(rtol=1e-4, atol=1e-5)


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
    dict(q_offset=-4, pads=(0, 0)),                 # ring key shard, part
                                                    # of it visible
    dict(q_offset=-16, pads=(0, 0)),                # a shard wholly masked
    dict(L=16, S=21, hd=64, causal=False, pads=(0, 5)),  # CLIP's head_dim,
                                                    # ragged S
])
def test_flash_plain_matches_jax_kernel(case):
    """Valid rows: out and lse within TOL.  A row that sees no key (a ring
    shard above the diagonal) has an unspecified out, but on both sides an
    lse of at most -1e29 (JAX's -1e30 ln 2 where its block runs no key
    tile; the plain version's (-1e30 + log2 S) ln 2), so the backward's
    ``lse <= NEG_INF / 2`` test zeroes its gradients."""
    case = dict(case)
    q_offset = case.pop("q_offset", 0)
    causal = case.pop("causal", True)
    q, k, v, mask = _data(**case)
    hd = q.shape[-1]
    # a ragged S is padded to JAX's key block, the pad masked, as its
    # wrapper (flash_mha) does; the port's plain version takes it as it is
    pad = -k.shape[1] % 8
    kj, vj = (np.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0))) for t in (k, v))
    out_j, lse_j = _flash_fwd_res(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(kj).transpose(0, 2, 1, 3),
        jnp.asarray(vj).transpose(0, 2, 1, 3),
        jnp.asarray(np.pad(mask, ((0, 0), (0, pad)))), q_offset, causal,
        1.0 / math.sqrt(hd), 8, 8, True)
    out_t, lse_t = flash_fwd_plain(*map(torch.from_numpy, (q, k, v, mask)),
                                   q_offset=q_offset, causal=causal)
    rows = _valid_rows(mask, q.shape[1], q_offset, causal)
    _cmp_rows(out_t.numpy(), np.asarray(out_j).transpose(0, 2, 1, 3), rows,
              **TOL)
    lse_rows = np.asarray(lse_j) * rows[:, None, :]
    np.testing.assert_allclose(lse_t.numpy() * rows[:, None, :], lse_rows,
                               **TOL)
    dead = np.broadcast_to(~rows[:, None, :], lse_t.shape)
    assert (np.asarray(lse_j)[dead] <= -1e29).all()
    assert (lse_t.numpy()[dead] <= -1e29).all()
    if q_offset == -16:  # every row: the check above is not vacuous
        assert dead.all()


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
    """CPU tensors take the plain versions and never count a launch; a
    query that needs grad runs the differentiable ``flash_mha``, whose
    backward is ``flash_bwd_plain`` on the CPU."""
    q, k, v, mask = map(torch.from_numpy, _data(seed=4))
    before = (flash_fwd.launches, tflash.flash_bwd_fused.launches,
              tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    out, lse = flash_fwd(q, k, v, mask)
    ref, ref_lse = flash_fwd_plain(q, k, v, mask)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    dout = torch.ones_like(q)
    delta = (dout * out).sum(-1).transpose(1, 2)
    want = tflash.flash_bwd_plain(q, k, v, mask, dout, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(
        tflash.flash_bwd_fused(q, k, v, mask, dout, lse, delta), want))
    assert torch.equal(tflash.flash_bwd_dq(q, k, v, mask, dout, lse, delta),
                       want[0])
    assert all(torch.equal(a, b) for a, b in zip(
        tflash.flash_bwd_dkv(q, k, v, mask, dout, lse, delta), want[1:]))
    qg = q.clone().requires_grad_(True)
    flash_mha(qg, k, v, mask).sum().backward()
    assert torch.equal(qg.grad, want[0])
    assert (flash_fwd.launches, tflash.flash_bwd_fused.launches,
            tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == before


def _bhld(t):
    """(b, L, H, hd) <-> (b, H, L, hd), numpy or jax."""
    return t.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("which", ["fused", "dq", "dkv"])
@pytest.mark.parametrize("case", [
    dict(),                                      # GQA 4:2, left padding
    dict(L=12, S=12, H=4, KH=4, pads=(0, 5)),    # MHA, L not a tile multiple
    dict(L=8, S=24, q_offset=16, pads=(2, 0)),   # queries into a cache
    dict(pads=(9, 0)),                           # 9 fully-masked query rows
    # ring attention key shards at a negative q_offset
    dict(L=8, S=16, q_offset=-4, pads=(2, 0)),   # part of the shard visible
    dict(L=8, S=16, q_offset=-16, pads=(2, 0)),  # the whole shard masked
    # the same two with the global rows' lse and delta (a forward over a
    # preceding shard and this one), so every row's lse is finite and the
    # mask, not the lse, must zero p on the masked keys
    dict(L=8, S=16, q_offset=-4, pads=(2, 0), global_rows=True),
    dict(L=8, S=16, q_offset=-16, pads=(2, 0), global_rows=True),
])
def test_flash_bwd_plain_matches_jax_kernels(which, case):
    """``flash_bwd_plain`` against the JAX kernel it stands for, fed the
    same q, k, v, dO and the JAX forward's lse and delta; queries that see
    no key get exactly zero dq, and keys that no query sees exactly zero dk
    and dv."""
    case = dict(case)
    q_offset = case.pop("q_offset", 0)
    global_rows = case.pop("global_rows", False)
    q, k, v, mask = _data(**case)
    hd, L, S = q.shape[-1], q.shape[1], k.shape[1]
    dout = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    jq, jk, jv, jdo = (jnp.asarray(_bhld(t)) for t in (q, k, v, dout))
    scale = 1.0 / math.sqrt(hd)
    if global_rows:  # keys of a preceding shard at [0, S), this one at S
        rng = np.random.default_rng(10)
        kp, vp = (rng.standard_normal(k.shape).astype(np.float32)
                  for _ in range(2))
        fk, fv = (jnp.asarray(_bhld(np.concatenate(t, axis=1)))
                  for t in ((kp, k), (vp, v)))
        fmask = np.concatenate([np.ones_like(mask), mask], axis=1)
        out, lse = _flash_fwd_res(jq, fk, fv, jnp.asarray(fmask),
                                  S + q_offset, True, scale, 4, 4, True)
        assert np.all(np.asarray(lse) > -1e29)  # every row sees a key
    else:
        out, lse = _flash_fwd_res(jq, jk, jv, jnp.asarray(mask), q_offset,
                                  True, scale, 4, 4, True)
    delta = jnp.sum(jdo * out, axis=-1)
    args = (jq, jk, jv, jnp.asarray(mask), jdo, lse, delta, q_offset, True,
            scale)
    if which == "fused":
        want = _flash_bwd_fused(*args, True)
    elif which == "dq":
        want = (_flash_bwd_dq(*args, 4, 4, True),)
    else:
        want = _flash_bwd_dkv(*args, 4, 4, True)
    got = tflash.flash_bwd_plain(
        *map(torch.from_numpy, (q, k, v, mask, dout)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta)),
        q_offset)
    got = {"fused": got, "dq": got[:1], "dkv": got[1:]}[which]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _bhld(np.asarray(w)), **GTOL)
    dead = ~_valid_rows(mask, L, q_offset)
    if which != "dkv":
        assert np.all(got[0].numpy()[dead] == 0)
    qpos = np.arange(L)[:, None] + q_offset
    seen = ((mask[:, None, :] > 0) & (qpos >= np.arange(S))[None]).any(1)
    for g in got[-2:] if which != "dq" else ():
        assert np.all(g.numpy()[~seen] == 0)  # (b, S): keys no query sees


@pytest.mark.parametrize("L,S,q_offset,H,KH,bwd_block", [
    (13, 13, 0, 4, 2, 4),        # port: fused; JAX: the dq + dkv pair
    (5, 21, 16, 4, 2, 1024),     # port: fused; JAX: fused
    (1100, 1100, 0, 2, 1, 1024),  # port: dq + dkv (past 1024); JAX: pair
])
def test_flash_mha_grads_match_jax(L, S, q_offset, H, KH, bwd_block):
    """Gradients of the port's autograd ``flash_mha`` against ``jax.grad``
    through the JAX ``flash_mha``, on both sides of the backward dispatch,
    with a cotangent on every row (fully-masked ones included)."""
    b = 2 if L < 1000 else 1
    q, k, v, mask = _data(b=b, L=L, S=S, H=H, KH=KH, pads=(3, 0)[:b],
                          seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = j_flash(q_, k_, v_, jnp.asarray(mask), q_offset=q_offset,
                      block_q=4 if L < 1000 else 512,
                      block_k=4 if L < 1000 else 512,
                      bwd_block_q=bwd_block, bwd_block_k=bwd_block,
                      interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    (flash_mha(tq, tk, tv, torch.from_numpy(mask), q_offset=q_offset)
     * torch.from_numpy(w)).sum().backward()
    for g, ww in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), **GTOL)


@pytest.mark.parametrize("L,want", [(1024, "fused"), (1025, "pair")])
def test_flash_mha_backward_calls_the_dispatched_kernels(monkeypatch, L,
                                                         want):
    """The autograd backward takes ``flash_bwd_fused`` up to the boundary
    and ``flash_bwd_dq`` + ``flash_bwd_dkv`` past it (two heads: one fp32
    head of head_dim <= 16 is the rank route, which always takes its own
    pair, ``tests/test_torch_rank_flash.py``)."""
    calls = []
    for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        fn = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    q, k, v, mask = map(torch.from_numpy, _data(b=1, L=L, S=L, H=2, KH=2,
                                                hd=4, pads=(0,), seed=7))
    q.requires_grad_(True)
    flash_mha(q, k, v, mask).sum().backward()
    assert calls == (["flash_bwd_fused"] if want == "fused" else
                     ["flash_bwd_dq", "flash_bwd_dkv"])


def test_bwd_dispatch_rule():
    """The fused backward when L and S, each padded to the forward block
    (512, clamped to the length), fit one 1024 backward block; the dq + dkv
    pair otherwise (``_flash_vjp_bwd`` after ``flash_mha``'s clamping)."""
    fused = [(1, 1), (333, 333), (512, 512), (513, 100), (1024, 1024),
             (896, 928), (100, 1024)]
    split = [(1025, 1025), (1024, 1025), (1025, 100), (1100, 1100),
             (1536, 1536), (2048, 2048), (4096, 4096), (128, 2048)]
    assert all(tflash.use_fused_bwd(L, S) for L, S in fused)
    assert not any(tflash.use_fused_bwd(L, S) for L, S in split)
