"""Port parity: MokA's flash rank attention (``MokaSpec.flash_rank_attn``,
the rank route of ``ops.flash_attention``: one head of head_dim r in fp32,
TPU kernels 1-4 as ``kernels/csrc/flash_rank.cu``) against the JAX package
on the CPU, same numpy inputs on both sides.  The JAX kernels run in Pallas
interpret mode, as its own tests run them; the port runs the plain
versions, which CPU tensors take.

A sample with no question token has all-zero keys: its rows come out zero
in both packages.  The rank kernels visit every key tile, so they equal the
plain version on such rows whatever the keys (held on the card,
``tests/test_torch_package.py`` and ``chip_smoke.py``); JAX's kernels
average over the key tiles they pad to, so against JAX a fully masked
sample is compared with zero keys, the only way MokA produces one.

Remat: JAX names the flash residuals inside ``flash_mha``'s forward rule,
so its policies keep or drop those of every flash call of a layer, the 14
rank calls of AVT's seven projections included.  Its compiled gradient
shows how many rank forwards the recompute reruns (one p·v product each,
inside ``rematted_computation``): 14 a layer under full remat, none under
``proj_lse``.  The port's per-call residual slots (``_RematSaves``) must
give the same counts.

The decoder tests take ``tests/test_torch_train.py``'s tiny world (its
fine-tune loss, LoRA dropout fed JAX's bits) with one sample's question
removed.

Tolerances: ``tests/test_moka_op.py``'s for this path, 1e-5 for outputs
and 2e-4 relative (+ 1e-6) for gradients (the decoder's against JAX too,
as ``tests/test_torch_remat.py``'s); the port's remat against its own
no-remat gradients 1e-6 relative (the recompute redoes the same fp32
arithmetic)."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.ops import flash_attention as jfa
from moka_tpu.ops import moka as jm
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import flash_attention as fa
from moka_tpu_torch.ops import moka as tm
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from tests.test_torch_moka import _inputs, _specs, _t
from tests.test_torch_remat import POLICIES
from tests.test_torch_train import (JCFG, JaxKey, _np,
                                    world)  # noqa: F401 (world: a fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=1e-6)
RANK_CALLS = 14  # a layer: 7 projections x AVT's 2 attending modalities


def test_rank_route_dispatch():
    """fp32 with one head takes the rank route at any head_dim (65, 128
    and 512 too); bf16 and multi-head fp32 do not; a head dim between the
    built ones runs in the next one, and one past 64 at the next multiple
    of 64 (the wide kernels), padded with zero columns; what stays refused
    is another head count, not a width."""
    def qk(dtype, H, hd):
        return (torch.zeros((1, 4, H, hd), dtype=dtype),
                torch.zeros((1, 4, H, hd), dtype=dtype))
    for hd in (1, 2, 4, 6, 16, 32, 64, 65, 128, 512):
        assert fa.is_rank_route(*qk(torch.float32, 1, hd))
    assert not fa.is_rank_route(*qk(torch.float32, 2, 4))
    assert not fa.is_rank_route(*qk(torch.float32, 2, 128))
    assert not fa.is_rank_route(*qk(torch.bfloat16, 1, 4))
    assert not fa.is_rank_route(*qk(torch.bfloat16, 32, 128))
    assert fa.RANK_HEAD_DIMS == (4, 8, 16, 32, 64)
    assert [fa.rank_built_dim(h) for h in (1, 3, 5, 6, 12, 20, 33, 64, 65,
                                           96, 128, 129, 512)] == \
        [4, 4, 8, 8, 16, 32, 64, 64, 128, 128, 128, 192, 512]
    q, k = qk(torch.float32, 1, 6)
    padded = fa._rank_inputs(q, k, k, torch.ones((1, 4)))
    assert [t.shape[-1] for t in padded[:3]] == [8, 8, 8]
    assert padded[3].dtype == torch.int32
    assert not hasattr(fa, "_refuse_wide_rank") and \
        not hasattr(fa, "RANK_MAX_HEAD_DIM")
    q, k = qk(torch.float32, 1, 65)
    padded = fa._rank_inputs(q, k, k, torch.ones((1, 4)))
    assert [t.shape[-1] for t in padded[:3]] == [128, 128, 128]
    with pytest.raises(ValueError, match="one head"):
        q, k = qk(torch.float32, 2, 65)
        fa._rank_inputs(q, k, k, torch.ones((1, 4)))


@pytest.mark.parametrize("L", [1024, 1025])
def test_rank_backward_calls_the_rank_pair(monkeypatch, L):
    """On both sides of the bf16 route's fused/pair boundary, the rank
    route's backward calls ``flash_rank_bwd_dq`` and
    ``flash_rank_bwd_dkv`` once each, and nothing else."""
    calls = []
    for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_rank_bwd_dq", "flash_rank_bwd_dkv"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    q, k, v, mask, _ = _rank_case(2, 1, L, 4)
    tq = torch.tensor(q, requires_grad=True)
    fa.flash_mha(tq, torch.tensor(k), torch.tensor(v), torch.tensor(mask),
                 causal=False).sum().backward()
    assert calls == ["flash_rank_bwd_dq", "flash_rank_bwd_dkv"]


def _rank_case(seed, b, L, hd, zero_masked_keys=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, L, 1, hd)).astype(np.float32)
    k = rng.standard_normal((b, L, 1, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, 1, hd)).astype(np.float32)
    mask = np.zeros((b, L), np.float32)
    for i in range(b - 1):
        s = int(rng.integers(0, L - 4))
        mask[i, s:s + 4 + i] = 1
    if zero_masked_keys:  # the last sample sees no key: MokA zeroes them
        k[-1] = v[-1] = 0
    dout = rng.standard_normal((b, L, 1, hd)).astype(np.float32)
    return q, k, v, mask, dout


@pytest.mark.parametrize("bwd_blocks", [1024, 16])
@pytest.mark.parametrize("L,hd", [(37, 4), (48, 8), (24, 16)])
def test_rank_flash_matches_jax_kernels(L, hd, bwd_blocks):
    """``flash_mha`` on the rank route, output and dq/dk/dv, against JAX's
    ``flash_mha`` in interpret mode with 16-row forward blocks (ragged at
    L 37) and a backward that takes the fused kernel (2, blocks 1024) or
    the dq + dkv pair (3-4, blocks 16); the lse against JAX's forward
    kernel (1) where L fills its blocks."""
    q, k, v, mask, dout = _rank_case(0, 3, L, hd)

    def jf(q_, k_, v_):
        return jfa.flash_mha(q_, k_, v_, jnp.asarray(mask), causal=False,
                             block_q=16, block_k=16, bwd_block_q=bwd_blocks,
                             bwd_block_k=bwd_blocks, interpret=True)

    def fwd_bwd(*args):
        out, vjp = jax.vjp(jf, *args)
        return out, vjp(jnp.asarray(dout))

    want, jgrads = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = fa.flash_mha(tq, tk, tv, torch.tensor(mask), causal=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert not got[-1].any()  # the sample with no visible key
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.tensor(dout))
    for n, g, w in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=n,
                                   **GRAD)
    if L % 16 == 0:
        _, lse = fa.flash_fwd(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), torch.tensor(mask), 0, False)
        _, jlse = jfa._flash_fwd_res(
            *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
            jnp.asarray(mask), 0, False, 1.0 / np.sqrt(hd), 16, 16, True)
        live = mask.any(axis=1)
        np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse)[live],
                                   **TOL)
    assert (fa.flash_rank_fwd.launches, fa.flash_rank_bwd_dq.launches,
            fa.flash_rank_bwd_dkv.launches) == (0, 0, 0)


L_LAYOUT = 64  # four of JAX's 16-key forward blocks
KEY_LAYOUTS = {  # name: (key spans, q_offset, causal)
    "span in the last key block": (((50, 62),), 0, False),
    "span across a block boundary": (((12, 21),), 0, False),
    "two spans": (((3, 7), (40, 50)), 0, False),
    "causal, rows before the first visible key": (((30, 40), (50, 56)), 8,
                                                  True)}


@pytest.mark.parametrize("bwd_blocks", [64, 16])
@pytest.mark.parametrize("layout", list(KEY_LAYOUTS))
def test_rank_route_key_layouts_match_jax(layout, bwd_blocks):
    """The rank route (``flash_mha``: fp32, one head of head_dim 4)
    against JAX's ``flash_mha`` in interpret mode (16-row forward blocks;
    the fused backward at 64, the dq + dkv pair at 16) on the key layouts
    the card's forward walks by their visible span: out and lse on the
    rows that see a key, dq/dk/dv on every row (zero where a row sees no
    key).  The second sample's first key is masked, a hole in its span.
    A row that sees no key reads the mean of V over all S keys, the
    port's contract (JAX's causal kernel averages only the key blocks it
    visits, so those rows are not compared with it)."""
    spans, q_offset, causal = KEY_LAYOUTS[layout]
    rng = np.random.default_rng(11)
    b, L, hd = 2, L_LAYOUT, 4
    q, k, v, dout = (rng.standard_normal((b, L, 1, hd)).astype(np.float32)
                     for _ in range(4))
    mask = np.zeros((b, L), np.float32)
    for start, stop in spans:
        mask[:, start:stop] = 1
    mask[1, spans[0][0]] = 0
    keys = np.arange(L)
    seen = (mask[:, None, :] > 0) & (
        keys[:, None] + q_offset >= keys[None, :] if causal else
        np.ones((L, L), bool))
    rows = seen.any(axis=-1)  # (b, L): the rows that see a key
    assert rows.any() and (rows.all() != causal)

    def jf(q_, k_, v_):
        return jfa.flash_mha(q_, k_, v_, jnp.asarray(mask), q_offset,
                             causal=causal, block_q=16, block_k=16,
                             bwd_block_q=bwd_blocks, bwd_block_k=bwd_blocks,
                             interpret=True)

    def fwd_bwd(*args):
        out, vjp = jax.vjp(jf, *args)
        return out, vjp(jnp.asarray(dout))

    want, jgrads = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = fa.flash_mha(tq, tk, tv, torch.tensor(mask), q_offset,
                       causal=causal)
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(want)[rows], **TOL)
    mean_v = np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape)
    np.testing.assert_allclose(got.detach().numpy()[~rows], mean_v[~rows],
                               **TOL)
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.tensor(dout))
    for n, g, w in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=n,
                                   **GRAD)
    assert not tgrads[0].numpy()[~rows].any()
    _, lse = fa.flash_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(mask), q_offset, causal)
    _, jlse = jfa._flash_fwd_res(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        jnp.asarray(mask), q_offset, causal, 1.0 / np.sqrt(hd), 16, 16, True)
    np.testing.assert_allclose(lse.numpy()[:, 0][rows],
                               np.asarray(jlse)[:, 0][rows], **TOL)
    assert (lse.numpy()[:, 0][~rows] <= -1e29).all()


@pytest.mark.parametrize("hd", [4, 16])
@pytest.mark.parametrize("layout", list(KEY_LAYOUTS))
def test_backward_zeros_where_no_pair_is_seen_match_jax(layout, hd):
    """The zeros the card's backward kernels store without walking (dq on
    a row that sees no key, dk and dv on a key no query sees) are JAX's:
    its dq and dk/dv kernels (interpret mode, 16-row blocks) and its fused
    backward, given its forward's lse and delta, give exactly 0 there, on
    the layouts of ``test_rank_route_key_layouts_match_jax`` (a hole in
    the second sample's span); so do the port's plain versions on the same
    lse and delta, which agree with JAX elsewhere within GRAD."""
    spans, q_offset, causal = KEY_LAYOUTS[layout]
    rng = np.random.default_rng(13)
    b, L = 2, L_LAYOUT
    q, k, v, dout = (rng.standard_normal((b, L, 1, hd)).astype(np.float32)
                     for _ in range(4))
    mask = np.zeros((b, L), np.float32)
    for start, stop in spans:
        mask[:, start:stop] = 1
    mask[1, spans[0][0]] = 0
    keys = np.arange(L)
    seen = (mask[:, None, :] > 0) & (
        keys[:, None] + q_offset >= keys[None, :] if causal else
        np.ones((L, L), bool))
    rows, cols = seen.any(axis=-1), seen.any(axis=1)  # (b, L), (b, S)
    assert (~rows).any() == causal and (~cols).any()
    scale = 1.0 / np.sqrt(hd)
    jq, jk, jv, jdo = (jnp.asarray(a).transpose(0, 2, 1, 3)
                       for a in (q, k, v, dout))
    jmask = jnp.asarray(mask)
    out, lse = jfa._flash_fwd_res(jq, jk, jv, jmask, q_offset, causal, scale,
                                  16, 16, True)
    delta = jnp.sum(jdo * out, axis=-1)
    args = (jq, jk, jv, jmask, jdo, lse, delta, q_offset, causal, scale)
    jdq = jfa._flash_bwd_dq(*args, 16, 16, True)
    jdk, jdv = jfa._flash_bwd_dkv(*args, 16, 16, True)
    fused = jfa._flash_bwd_fused(*args, True)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, dout))
    targs = (tq, tk, tv, torch.tensor(mask), tdo, torch.tensor(np.asarray(lse)),
             torch.tensor(np.asarray(delta)), q_offset, causal)
    tdq = fa.flash_bwd_dq_plain(*targs).numpy()
    tdk, tdv = (g.numpy() for g in fa.flash_bwd_dkv_plain(*targs))
    for n, j, t, where in (("dq", jdq, tdq, ~rows), ("dk", jdk, tdk, ~cols),
                           ("dv", jdv, tdv, ~cols)):
        j = np.asarray(j).transpose(0, 2, 1, 3)
        assert not j[where].any() and not t[where].any(), n
        np.testing.assert_allclose(t, j, err_msg=n, **GRAD)
    for n, j, t, where in zip(("dq", "dk", "dv"), fused, (tdq, tdk, tdv),
                              (~rows, ~cols, ~cols)):
        j = np.asarray(j).transpose(0, 2, 1, 3)
        assert not j[where].any(), f"fused {n}"
        np.testing.assert_allclose(t, j, err_msg=f"fused {n}", **GRAD)


def test_rank_inputs_pass_ready_tensors_through_and_check_the_rest():
    """The rank wrappers' input check (``_rank_inputs``, run before each of
    the three kernels): an fp32 q, k, v and an int32 contiguous mask on
    q's device come back as the same tensors, uncopied and uncast; a float
    or strided mask is cast once; head_dim 3 comes back padded to the
    built head_dim 4 and head_dim 65 to 128 (the wide kernels'); a wrong
    dtype, head count, head_dim (0), mask shape, lse shape or a misaligned
    tensor raises."""
    rng = np.random.default_rng(12)
    q, k, v, dout = (torch.tensor(rng.standard_normal((2, 24, 1, 4)),
                                  dtype=torch.float32) for _ in range(4))
    mask = torch.ones((2, 24), dtype=torch.int32)
    ins = fa._rank_inputs(q, k, v, mask)
    assert all(a is b for a, b in zip(ins, (q, k, v, mask)))
    lse = torch.zeros((2, 1, 24))
    ins = fa._rank_inputs(q, k, v, mask, dout, lse, lse)
    assert len(ins) == 7 and ins[4] is dout and ins[5] is lse
    for other in (mask.float(), torch.ones((24, 2), dtype=torch.int32).t()):
        m = fa._rank_inputs(q, k, v, other)[3]
        assert m.dtype == torch.int32 and m.is_contiguous()
        assert torch.equal(m, mask)
    with pytest.raises(TypeError, match="v is torch.float64"):
        fa._rank_inputs(q, k, v.double(), mask)
    wide = torch.zeros((2, 24, 1, 65))
    assert [t.shape[-1] for t in fa._rank_inputs(wide, wide, wide,
                                                 mask)[:3]] == [128] * 3
    with pytest.raises(ValueError, match="one head"):
        empty = torch.zeros((2, 24, 1, 0))
        fa._rank_inputs(empty, empty, empty, mask)
    three = fa._rank_inputs(q[..., :3], k[..., :3], v[..., :3], mask)
    assert all(torch.equal(t[..., :3], u[..., :3]) and not t[..., 3].any()
               for t, u in zip(three, (q, k, v)))  # padded to head_dim 4
    with pytest.raises(ValueError, match="one head"):
        fa._rank_inputs(q.expand(2, 24, 2, 4), k, v, mask)
    with pytest.raises(ValueError, match="attn_mask"):
        fa._rank_inputs(q, k, v, mask[:, :-1])
    with pytest.raises(ValueError, match="dout"):
        fa._rank_inputs(q, k, v, mask, dout[:, :-1], lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fa._rank_inputs(q, k, v, mask, dout, lse[..., :-1], lse)
    flat = torch.zeros(2 * 24 * 4 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._rank_inputs(flat[1:].view(2, 24, 1, 4), k, v, mask)


def test_fully_masked_rows_equal_the_plain_mean_and_send_nothing_back():
    """The rank route's contract on a row that sees no key: the mean of V
    over all S keys (what the kernels, visiting every key tile, also
    give), and zero gradients."""
    q, k, v, mask, dout = _rank_case(1, 2, 19, 4, zero_masked_keys=False)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_mha(tq, tk, tv, torch.tensor(mask), causal=False)
    np.testing.assert_allclose(out[-1].detach().numpy(),
                               np.broadcast_to(v[-1].mean(axis=0), (19, 1, 4)),
                               **TOL)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))
    assert not dq[-1].any() and not dk[-1].any() and not dv[-1].any()


@pytest.mark.parametrize("flavour,L", [("avt", 24), ("vt", 24), ("avt", 21)])
def test_moka_delta_flash_rank_matches_jax(flavour, L):
    """``moka_delta`` with ``flash_rank_attn`` against JAX's (interpret
    mode), the output and the adapter gradients, with a no-question sample
    (the last); and against the port's own plain rank attention (the same
    math, question window or not)."""
    js, ts = _specs(flavour)
    js, ts = js.with_flash_rank_attn(), ts.with_flash_rank_attn()
    x, a, bm, mod, q = _inputs(7, 3, L, 16, 12, js.num_modalities)
    cot = np.random.default_rng(8).standard_normal((3, L, 12)).astype(
        np.float32)

    def jf(a_, b_):
        return jm.moka_delta(jnp.asarray(x), a_, b_, jnp.asarray(mod),
                             jnp.asarray(q), js)

    want = jf(jnp.asarray(a), jnp.asarray(bm))
    jg = jax.grad(lambda a_, b_: jnp.sum(jf(a_, b_) * cot), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(bm))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(
        bm, requires_grad=True)
    got = tm.moka_delta(torch.tensor(x), ta, tb, torch.tensor(mod),
                        torch.tensor(q), ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    tg = torch.autograd.grad((got * torch.tensor(cot)).sum(), (ta, tb))
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
    for plain_spec in (_specs(flavour)[1], _specs(flavour, window=8)[1]):
        plain = tm.moka_delta(*_t(x, a, bm, mod, q), plain_spec)
        np.testing.assert_allclose(got.detach().numpy(), plain.numpy(), **TOL)


# ------------------------------------------------------- decoder, remat

SPEC_J = jm.MokaSpec.avt(rank=4, dropout_rate=0.05).with_flash_rank_attn()
SPEC = tm.MokaSpec.avt(rank=4, dropout_rate=0.05).with_flash_rank_attn()
CFG = LlamaConfig.tiny()
LOSS = dict(use_flash=True, fused_loss=True, ce_chunk=5)


@pytest.fixture(scope="module")
def rank_world(world):
    """``tests/test_torch_train.py``'s tiny world (fp32 base, B non-zero,
    a bench-style batch) with the second sample's question removed."""
    base, trainable, batch = world
    q = batch["question_mask"].copy()
    q[1] = 0
    return base, trainable, dict(batch, question_mask=q)


def _policy(name):
    return None if name == "full" else name


def _rank_reruns(policy):
    """Rank forwards a layer's recompute reruns: none where the policy
    keeps the flash residuals (the ``*_lse`` policies), else all 14."""
    kept = tllama.REMAT_POLICIES[_policy(policy)]
    return 0 if "flash_out" in kept else RANK_CALLS


def _port_grads(world, policy, monkeypatch=None):
    """The port's adapter gradients of the fine-tune loss (dropout fed
    JAX's bits) and the rank forwards run in the forward pass and in the
    backward."""
    base, trainable, batch = world
    counts = {"fwd": 0, "bwd": 0}
    phase = ["fwd"]
    if monkeypatch is not None:
        rank_fwd = fa.flash_rank_fwd

        def counted(*args, **kw):
            counts[phase[0]] += 1
            return rank_fwd(*args, **kw)

        monkeypatch.setattr(fa, "flash_rank_fwd", counted)
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = make_llama_moka_loss(CFG, SPEC, remat=policy is not False,
                                   remat_policy=_policy(policy or "full"),
                                   **LOSS)
    loss, _ = loss_fn(params, params_from_numpy(_np(base), "cpu"),
                      params_from_numpy(batch, "cpu"),
                      JaxKey(jax.random.key(7)))
    phase[0] = "bwd"
    return torch.autograd.grad(loss, leaves), counts


@pytest.fixture(scope="module")
def no_remat(rank_world):
    return _port_grads(rank_world, False)[0]


@pytest.mark.parametrize("policy", POLICIES)
def test_decoder_rank_flash_remat_counts_and_grads(rank_world, no_remat,
                                                   policy, monkeypatch):
    """Every policy: the forward runs the 14 rank forwards a layer once;
    the backward reruns all 14 unless the policy keeps the flash
    residuals, each call in its own slot; the gradients equal the
    no-remat ones."""
    grads, counts = _port_grads(rank_world, policy, monkeypatch)
    n = CFG.n_layers
    assert counts == {"fwd": RANK_CALLS * n, "bwd": _rank_reruns(policy) * n}
    for g, w in zip(grads, no_remat):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-9)


def _jax_rank_reruns(hlo: str) -> int:
    """Rank forwards in XLA's recompute: the p·v product of the forward
    kernel, (rows, r) contracting p's columns with v's rows, inside
    ``rematted_computation``."""
    n = 0
    for line in hlo.splitlines():
        if " dot(" in line and "rematted_computation" in line and \
                re.search(r"= f32\[\d+,4\]", line) and \
                "lhs_contracting_dims={1}, rhs_contracting_dims={0}" in line:
            n += 1
    return n


@pytest.mark.parametrize("policy", ["full", "proj_lse"])
def test_rank_recompute_and_grads_match_jax(rank_world, policy,
                                            monkeypatch):
    """JAX's compiled gradient reruns 14 rank forwards a layer under full
    remat and none under ``proj_lse``, as the port does; the port's
    gradients equal JAX's under the same policy."""
    base, trainable, batch = rank_world
    j_loss = j_make_loss(JCFG, SPEC_J, remat=True,
                         remat_policy=_policy(policy), **LOSS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = jax.jit(jax.grad(lambda tr: j_loss(
        tr, base, jb, jax.random.key(7))[0])).lower(trainable).compile()
    # the layers are a scan: the compiled text holds one layer's body
    assert _jax_rank_reruns(compiled.as_text()) == _rank_reruns(policy)
    want = compiled(trainable)
    grads, counts = _port_grads(rank_world, policy, monkeypatch)
    assert counts["bwd"] == _rank_reruns(policy) * CFG.n_layers
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"{policy} {path}", **GRAD)
