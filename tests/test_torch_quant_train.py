"""Port parity: the shipping quantized recipe's training step
(``bench.py``'s ``llama2_7b_int4a8_qh_sq8_plse``: int4 base, int8 head,
``a8_dots="full"``, ``save_q8=True``, ``proj_lse``, bf16 dots, LoRA
dropout) against the JAX package on the CPU, ``LlamaConfig.tiny()`` with
an fp32 base quantized by JAX and carried across by ``params_from_numpy``.

Route A runs the chunked CE on the a8 head; route B the fused lm_head + CE
(``pallas_ce=True``; JAX's Pallas kernels in interpret mode, the port's
plain versions).  Dropout is fed JAX's bits (``JaxKey``).

Tolerances.  The int8 codes are bit-exact for bit-equal inputs
(``tests/test_torch_quant.py``), but the two packages sum fp32 products in
other orders, so an input can differ in its last bits, and a per-token
rounding to int8 (the a8 activations, the cotangents of ``bwd_a8``, the
save set) then flips a code by one where a value sits on a rounding
boundary: one step of 1/127 of the token's max.  ``FLIPS`` bounds the
share of flipped codes in the first layer's seven rounded outputs
(measured: 0 of 24,576).  With bf16 dots the adapters' operands and
cotangents are rounded to bf16 (2^-8) where the fp32 inputs already
differ in their last bits: on an unquantized fp32 base with dropout that
alone puts the two packages' gradients up to 7.5e-3 apart (relative L2
per tensor), and the recipe's roundings bring it to 1.7e-2 (measured), so
gradients and parameters are held to ``GRAD_L2`` = 3e-2 and losses to
1e-4 relative (measured 4e-5).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg, TrainConfig as JTrain
from moka_tpu.models import llama as jllama
from moka_tpu.ops import quant as jq
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu.train import optim as joptim
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu.train.step import init_train_state as j_init
from moka_tpu.train.step import make_train_step as j_make_step
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import quant as tq
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from moka_tpu_torch.train.step import init_train_state, make_train_step
from tests.test_torch_train import (TOTAL, TRAIN, JaxKey, _np,
                                    world)  # noqa: F401 (world: a fixture)

JCFG, CFG = JCfg.tiny(), LlamaConfig.tiny()
JSPEC = JSpec.avt(rank=4, dropout_rate=0.05).with_bf16_dots() \
    .with_question_window(8)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.05).with_bf16_dots() \
    .with_question_window(8)
RECIPE = dict(remat=True, use_flash=True, fused_loss=True,
              remat_policy="proj_lse", a8_dots="full", save_q8=True,
              ce_chunk=5)
ROUTES = {"A": {}, "B": {"pallas_ce": True}}
GRAD_L2 = 3e-2
LOSS_RTOL = 1e-4
FLIPS = 1e-2


@pytest.fixture(scope="module")
def qworld(world):
    """``world``'s fp32 base quantized by JAX: int4 projections, int8
    lm_head (``quantize_llama_base(bits=4, head_bits=8)``)."""
    base, trainable, batch = world
    return jq.quantize_llama_base(base, bits=4, head_bits=8), trainable, batch


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_steps(qworld, n_steps, **loss):
    base, trainable, batch = qworld
    tx = joptim.make_optimizer(JTrain(**TRAIN), total_steps=TOTAL)
    step = j_make_step(j_make_loss(JCFG, JSPEC, **loss), tx, donate=False,
                       grad_taps=lambda g: g)
    state = j_init(trainable, tx, jax.random.key(7))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        state, m = step(state, base, jb)
        out.append((_np(dataclasses.replace(state, rng=None)), _np(m)))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_recipe_steps_match_jax(qworld, route):
    """Two AdamW steps of ``make_train_step``: the loss, grad norm and
    every adapter gradient of each step, and every parameter after it."""
    loss = dict(RECIPE, **ROUTES[route])
    runs = _jax_steps(qworld, 2, **loss)
    base, trainable, batch = qworld
    tx = toptim.make_optimizer(TrainConfig(**TRAIN), total_steps=TOTAL)
    step = make_train_step(make_llama_moka_loss(CFG, SPEC, **loss), tx,
                           grad_taps=lambda g: g)
    frozen = params_from_numpy(_np(base), "cpu")
    assert frozen["layers"]["q"]["w_i4"].dtype == torch.uint8
    assert frozen["lm_head"]["w_i8"].dtype == torch.int8
    assert frozen["lm_head"]["scale"].dtype == torch.float32
    state = init_train_state(params_from_numpy(_np(trainable), "cpu"), tx,
                             JaxKey(jax.random.key(7)))
    tb = params_from_numpy(batch, "cpu")
    for jstate, jm in runs:
        state, m = step(state, frozen, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_L2)
        jl = jm["grad_taps"]["adapters"]["layers"]
        jp = jstate.params["adapters"]["layers"]
        for name, pair in m["grad_taps"]["adapters"]["layers"].items():
            for ab, g in pair.items():
                assert _rel(g.numpy(), jl[name][ab]) <= GRAD_L2, (name, ab)
                p = state.params["adapters"]["layers"][name][ab].numpy()
                assert _rel(p, jp[name][ab]) <= GRAD_L2, (name, ab)


def _grads_both(qworld, jax_remat=True, **loss):
    """(JAX loss, grads) and (port loss, grads), one loss call each."""
    base, trainable, batch = qworld
    j_loss = j_make_loss(JCFG, JSPEC, **dict(loss, remat=jax_remat))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(3)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda tr: j_loss(tr, base, jb, key)[0]))(trainable)
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tv, _ = make_llama_moka_loss(CFG, SPEC, **loss)(
        params, params_from_numpy(_np(base), "cpu"),
        params_from_numpy(batch, "cpu"), JaxKey(key))
    tg = torch.autograd.grad(tv, leaves)
    return (float(jv), jax.tree.leaves(jg)), (float(tv.detach()), tg)


@pytest.mark.parametrize("save_q8", ["fp8", ("q", "up"), ("fp8", "down")])
def test_other_save_sets_match_jax(qworld, save_q8):
    """fp8 saves, and explicit tuples (int8, and fp8 on the down output,
    which is rounded but never kept).  The port runs remat under
    ``proj_lse``; with fp8 the JAX reference runs without remat: on the CPU
    JAX's own gradients under remat with an fp8 save set are 44% (relative
    L2) away from its gradients without remat for the same forward values,
    while the port's two agree exactly (ROADMAP.md section 3).  An fp8
    rounding moves a value by up to 2^-4 of it, so a code that flips on a
    rounding boundary costs more than an int8 one: fp8 gradients are held
    to 3x ``GRAD_L2`` (measured up to 3.1e-2) and the loss to 1e-3."""
    fp8 = "fp8" in save_q8
    (jv, jg), (tv, tg) = _grads_both(qworld, jax_remat=not fp8,
                                     **dict(RECIPE, save_q8=save_q8))
    np.testing.assert_allclose(tv, jv, rtol=1e-3 if fp8 else LOSS_RTOL)
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b) <= (3 if fp8 else 1) * GRAD_L2


def test_rounded_outputs_flip_few_codes(qworld):
    """The per-token int8 codes of the first layer's seven rounded
    projection outputs, port against JAX on the same inputs: only codes on
    a rounding boundary may differ, by one."""
    base, trainable, batch = qworld
    emb = np.asarray(base["embed"])[batch["tokens"]]
    masks = jllama.MaskBundle(jnp.asarray(batch["modality_masks"]),
                              jnp.asarray(batch["question_mask"]))
    jcfg = dataclasses.replace(JCFG, n_layers=1)
    cfg = dataclasses.replace(CFG, n_layers=1)
    one = {**base, "layers": jax.tree.map(lambda t: t[:1], base["layers"])}
    ad = {"layers": jax.tree.map(lambda t: t[:1],
                                 trainable["adapters"]["layers"])}
    names = tuple(tllama.PROJ_DIMS)
    got, want = {}, {}
    orig = jq._q8rt_impl

    def j_tap(name, y):  # JAX's codes, by projection (y is traced)
        jax.debug.callback(lambda q: want.__setitem__(name, np.asarray(q)),
                           jq._a8_quantize(y)[0])
        return orig(name, y)

    jq._q8rt_impl = j_tap
    try:
        jllama.forward(one, jcfg, adapters=ad, spec=JSPEC,
                       inputs_embeds=jnp.asarray(emb), masks=masks,
                       a8_dots="full", save_q8=names, logits=False)
    finally:
        jq._q8rt_impl = orig
    t_orig = tq.q8_codes

    def t_tap(y):
        codes = t_orig(y)
        got[f"proj_{names[len(got)]}"] = codes[0]
        return codes

    tq.q8_codes = t_tap
    try:
        tllama.forward(params_from_numpy(_np(one), "cpu"), cfg,
                       adapters=params_from_numpy(_np(ad), "cpu"), spec=SPEC,
                       inputs_embeds=torch.from_numpy(emb),
                       masks=params_from_numpy(masks, "cpu"), a8_dots="full",
                       save_q8=names, logits=False)
    finally:
        tq.q8_codes = t_orig
    assert set(got) == set(want) == {f"proj_{n}" for n in names}
    flipped = total = 0
    for tag, codes in got.items():
        d = np.abs(codes.numpy().astype(np.int32)
                   - np.asarray(want[tag]).astype(np.int32))
        assert d.max() <= 1, tag
        flipped, total = flipped + int((d > 0).sum()), total + d.size
    assert flipped / total <= FLIPS


def test_save_q8_keeps_int8_codes_and_rounds_down(qworld, monkeypatch):
    """Under ``proj_lse`` + ``save_q8``: each layer keeps int8 codes + fp32
    per-token scales for q, k, v, o, gate, up (about half the bytes of
    the bf16 outputs) and the flash residuals; the down output is rounded
    in the forward but not kept; the recompute reads every kept entry and
    reruns no frozen product."""
    base, trainable, batch = qworld
    layers, rounded = [], []

    class Saves(tllama._RematSaves):
        def __init__(self, names):
            super().__init__(names)
            layers.append(self)

    roundtrip = tllama.q8_roundtrip

    def logged(y, keep=None):
        rounded.append(keep is not None)
        return roundtrip(y, keep)

    monkeypatch.setattr(tllama, "_RematSaves", Saves)
    monkeypatch.setattr(tllama, "q8_roundtrip", logged)
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = make_llama_moka_loss(CFG, SPEC, **RECIPE)(
        params, params_from_numpy(_np(base), "cpu"),
        params_from_numpy(batch, "cpu"), DropoutKey(2))
    b, L = batch["tokens"].shape
    for s in layers:
        tags = {f"proj_{n}" for n in tllama.PROJ_DIMS} - {"proj_down"}
        assert set(s.kept) == tags | {"flash_out", "flash_lse"}
        kept = sum(tq.quantized_bytes(s.kept[t]) for t in tags)
        bf16 = sum(2 * b * L * s.kept[t][0].shape[-1] for t in tags)
        for t in tags:
            q, sc = s.kept[t]
            assert q.dtype == torch.int8 and sc.dtype == torch.float32
            assert sc.shape == (b, L, 1)
        assert 0.5 <= kept / bf16 <= 0.6
    # per layer: 7 rounded outputs in the forward, 6 of them kept
    assert rounded == ([True] * 6 + [False]) * CFG.n_layers
    rounded.clear()
    torch.autograd.grad(loss, leaves)
    # the recompute rounds nothing again: kept outputs come from their
    # codes, and it stops before the down projection
    assert rounded == []
