"""Port parity at MokA ranks beyond 4, 8 and 16: kernel 5's wrapper, kernels
6-7's plain versions and the rank route against the JAX package on the CPU,
and a decoder forward at ranks 6, 32 and 128 and a fine-tune step's
gradients at ranks 6 and 32.

JAX's kernels take any rank, and so do the port's: kernel 5 and the rank
route are built for ranks (head dims) 4, 8, 16, 32 and 64, a rank between
runs padded with zero columns, and past 64 they run at the next multiple
of 64 (kernel 5's wide path, the rank kernels' wide instances); kernels
6-7 take every M*r.  On the CPU each wrapper runs its plain version, at
any rank, as JAX's kernel does; the card's checks live in chip_smoke.py's
phases 19 (ranks up to 64) and 20 (past 64).

Tolerances: fp32 on both sides in other summation orders.  Kernel 5 to
3e-5 relative + absolute, as ``tests/test_moka_pallas.py`` holds JAX's
kernel to its reference; kernels 6-7 to 1e-5 relative + 1e-6 of the
largest value (their masks exact: the same forced words); the rank route
and the decoder to 1e-5, gradients to 1e-4 relative + 1e-6 absolute (one
more reduction).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg
from moka_tpu.models import llama as jllama
from moka_tpu.ops import moka as jm
from moka_tpu.ops.fused_dropout import dropout_a_proj as j_drop_a
from moka_tpu.ops.moka_pallas import moka_delta_fused as j_fused
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import fused_dropout as fd
from moka_tpu_torch.ops import moka as tm
from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from tests.test_torch_moka import _inputs, _specs
from tests.test_torch_train import JaxKey

KERNEL5 = dict(rtol=3e-5, atol=3e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flavour", ["avt", "vt"])
@pytest.mark.parametrize("rank", [1, 2, 3, 6, 12, 32, 64, 65, 128, 512])
def test_fused_delta_matches_jax_kernel(flavour, rank):
    """The port's ``moka_delta_fused`` on CPU tensors (its plain version)
    against JAX's kernel in interpret mode (block 8: L 13 leaves a ragged
    block), where the port's wrapper used to refuse every rank but 4, 8
    and 16, then every rank past 64."""
    js, ts = _specs(flavour, rank=rank)
    ins = _inputs(rank, 2, 13, 16, 12, js.num_modalities, rank=rank)
    want = j_fused(*map(jnp.asarray, ins), js, 8, True)
    got = moka_delta_fused(*map(torch.from_numpy, ins), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL5)


@pytest.mark.parametrize("rank", [6, 32])
def test_fused_delta_grads_match_jax(rank):
    """x, A and B gradients of the fused delta (autograd through the plain
    ``moka_delta``) against ``jax.grad`` through JAX's custom VJP."""
    js, ts = _specs("avt", rank=rank)
    x, a, bm, mod, q = _inputs(40 + rank, 2, 13, 16, 12, 3, rank=rank)
    cot = np.random.default_rng(rank).standard_normal(
        (2, 13, 12)).astype(np.float32)

    _, vjp = jax.vjp(lambda x_, a_, b_: j_fused(
        x_, a_, b_, jnp.asarray(mod), jnp.asarray(q), js, 8, True),
        *map(jnp.asarray, (x, a, bm)))
    want = vjp(jnp.asarray(cot))
    ts_ = [torch.tensor(v, requires_grad=True) for v in (x, a, bm)]
    out = moka_delta_fused(*ts_, torch.from_numpy(mod), torch.from_numpy(q),
                           ts)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ts_)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


@pytest.mark.parametrize("M,r", [(1, 3), (3, 2), (3, 6), (3, 32), (3, 64),
                                 (3, 96), (3, 128)])
def test_dropout_a_proj_matches_jax_at_any_width(M, r):
    """Kernels 6-7's plain versions with forced words (the words the CUDA
    kernels also take) against JAX's kernels in interpret mode at M*r 3,
    6, 18, 96, 192, 288 and 384: out, dx and dA; dropped inputs get no
    gradient."""
    b, L, d, rate = 2, 13, 32, 0.3
    rng = np.random.default_rng(M * r)
    x = rng.standard_normal((b, L, d)).astype(np.float32)
    a = (rng.standard_normal((M, d, r)) * 0.1).astype(np.float32)
    g = rng.standard_normal((M, b, L, r)).astype(np.float32)
    bits = rng.integers(0, 1 << 32, (b * L, d), dtype=np.uint64).astype(
        np.uint32)

    def jloss(x_, a_):
        out = j_drop_a(x_, a_, jax.random.key(0), rate, block_rows=8,
                       interpret=True, _force_bits=jnp.asarray(bits))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (jdx, jda) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(a))
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(a, requires_grad=True)
    got = fd.dropout_a_proj(xt, at, DropoutKey(0), rate,
                            _force_bits=torch.from_numpy(
                                bits.astype(np.int64)))
    assert tuple(got.shape) == (M, b, L, r)
    (got * torch.from_numpy(g)).sum().backward()
    for t, j in ((got.detach(), want), (xt.grad, jdx), (at.grad, jda)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(j).max()))
    dropped = bits.reshape(b, L, d) >= fd.threshold(rate)
    assert np.all(xt.grad.numpy()[dropped] == 0)


@pytest.mark.parametrize("hd", [1, 2, 6, 32, 64, 65, 128, 256, 512])
def test_rank_route_matches_jax(hd):
    """The rank route (``flash_rank_space_cross_attention``: one fp32 head
    of head_dim r through ``flash_mha``) against JAX's (its flash kernels
    in interpret mode), the output and the gradients of q and the keys,
    with a sample that has no question token."""
    b, L = 2, 16  # the step test's shape: JAX reuses its traced kernels
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((b, L, hd)).astype(np.float32)
    keys = rng.standard_normal((b, L, hd)).astype(np.float32)
    qm = np.zeros((b, L), np.float32)
    qm[0, 3:9] = 1
    keys[1] = 0  # no question: all-zero keys, as MokA makes them
    cot = rng.standard_normal((b, L, hd)).astype(np.float32)

    def jf(q_, k_):
        return jm.flash_rank_space_cross_attention(q_, k_, jnp.asarray(qm),
                                                   hd)

    want, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(keys))
    jg = vjp(jnp.asarray(cot))
    tq, tk = (torch.tensor(v, requires_grad=True) for v in (q, keys))
    got = tm.flash_rank_space_cross_attention(tq, tk, torch.from_numpy(qm),
                                              hd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert not got[1].any()
    tg = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), (tq, tk))
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


# the tiny decoder at one layer: the JAX reference runs its kernels in
# interpret mode, seconds a layer
JCFG = dataclasses.replace(JCfg.tiny(), n_layers=1)
CFG = dataclasses.replace(LlamaConfig.tiny(), n_layers=1)


def _tiny_world(rank, seed):
    """A tiny fp32 base and AVT adapters at ``rank`` with B non-zero, as
    numpy trees (the port's initializers: JAX's eager init takes seconds),
    and one bench-style batch (text / video / audio 1/2, 1/4, 1/4, a
    question span, a quarter of the labels ignored)."""
    g = torch.Generator().manual_seed(seed)
    base = tllama.init_llama_params(g, CFG, device="cpu", dtype=torch.float32)
    ad = tllama.init_moka_adapters(g, CFG, tm.MokaSpec.avt(rank=rank),
                                   device="cpu")
    for p in ad["layers"].values():
        p["b"] = torch.randn(p["b"].shape, generator=g) * 0.05

    def as_numpy(tree):
        return {k: as_numpy(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}

    b, L = 2, 16
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, JCFG.vocab_size, (b, L)).astype(np.int32)
    labels = np.where(rng.random((b, L)) < 0.25, -100, toks).astype(np.int32)
    mod = np.zeros((3, b, L), np.float32)
    mod[0, :, :L // 2] = 1
    mod[1, :, L // 2:3 * L // 4] = 1
    mod[2, :, 3 * L // 4:] = 1
    q = np.zeros((b, L), np.float32)
    q[:, 2:6] = 1
    batch = dict(tokens=toks, labels=labels, modality_masks=mod,
                 question_mask=q)
    return as_numpy(base), as_numpy(ad), batch


@pytest.mark.parametrize("rank", [6, 32, 128])
def test_decoder_fused_moka_matches_jax(rank):
    """``llama.forward(use_fused_moka=True)`` (kernel 5's wrapper on CPU
    tensors) against JAX's decoder at ranks 6, 32 and 128, where the port
    used to raise (``LlamaConfig.tiny()`` at one layer)."""
    base, ad, batch = _tiny_world(rank, rank)
    js = jm.MokaSpec.avt(rank=rank, dropout_rate=0.0)
    ts = tm.MokaSpec.avt(rank=rank, dropout_rate=0.0)
    emb = np.random.default_rng(rank).standard_normal(
        (2, 16, JCFG.dim)).astype(np.float32)
    mod, q = batch["modality_masks"], batch["question_mask"]
    want, _ = jllama.forward(jax.tree.map(jnp.asarray, base), JCFG,
                             adapters=jax.tree.map(jnp.asarray, ad), spec=js,
                             inputs_embeds=jnp.asarray(emb),
                             masks=jllama.MaskBundle(jnp.asarray(mod),
                                                     jnp.asarray(q)))
    got, _ = tllama.forward(
        params_from_numpy(base, "cpu"), CFG,
        adapters=params_from_numpy(ad, "cpu"),
        spec=ts, inputs_embeds=torch.from_numpy(emb),
        masks=tllama.MaskBundle(torch.from_numpy(mod), torch.from_numpy(q)),
        use_flash=True, use_fused_moka=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("rank", [6, 32])
def test_fused_dropout_flash_rank_step_matches_jax(rank):
    """The fine-tune loss and every adapter gradient with fused dropout
    (kernels 6-7 at M*r 18 and 96) and the rank route (head_dim 6 and 32)
    against JAX's at the same dropout bits: the decoder's own attention is
    plain on both sides and the adapters sit on q and down (the slice's
    kernels are the point)."""
    base, ad, batch = _tiny_world(rank, 100 + rank)
    # adapters on a projection of each width (q: dim -> dim, down:
    # intermediate -> dim): JAX's kernels run in interpret mode
    ad = {"layers": {n: ad["layers"][n] for n in ("q", "down")}}
    spec_j = jm.MokaSpec.avt(rank=rank, dropout_rate=0.05) \
        .with_fused_dropout().with_flash_rank_attn()
    spec_t = tm.MokaSpec.avt(rank=rank, dropout_rate=0.05) \
        .with_fused_dropout().with_flash_rank_attn()
    loss_kw = dict(remat=False, use_flash=False, fused_loss=True,
                   ce_chunk=8)
    trainable = {"adapters": ad}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss = j_make_loss(JCFG, spec_j, **loss_kw)
    (jl, _), jg = jax.value_and_grad(
        lambda tr: j_loss(tr, jax.tree.map(jnp.asarray, base), jb,
                          jax.random.key(9)), has_aux=True)(
        jax.tree.map(jnp.asarray, trainable))
    params = params_from_numpy(trainable, "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    t_loss = make_llama_moka_loss(CFG, spec_t, **loss_kw)
    loss, _ = t_loss(params, params_from_numpy(base, "cpu"),
                     params_from_numpy(batch, "cpu"),
                     JaxKey(jax.random.key(9)))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=str(path), **GRAD)
