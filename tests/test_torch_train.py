"""Port parity: losses, optimizer and the MokA train step against the JAX
package on the CPU, fp32, ``LlamaConfig.tiny()``.

The JAX step runs as the package runs it (jitted; flash attention in Pallas
interpret mode, the fused backward kernel at these lengths).  Dropout is on
(rate 0.05): the port's key is replaced by ``JaxKey``, which has
``DropoutKey``'s split/fold_in/bits shape and draws its bits from
``jax.random`` along the same path, so both packages drop the same inputs.

Tolerances: both sides compute in fp32 with other summation orders.  Losses
and gradient norms to 1e-5 relative; gradients to 1e-4 relative + 1e-6
absolute (observed ~1e-6 relative); parameters after an update to 1e-4
relative + 1e-5 absolute: AdamW divides each gradient by its own running
magnitude, so an element whose gradient sat at rounding noise could move by
up to the learning rate (1e-2 here); 1e-5 is a thousandth of it.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg, TrainConfig as JTrain
from moka_tpu.models import llama as jllama
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu.train import optim as joptim
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu.train.step import init_train_state as j_init
from moka_tpu.train.step import make_train_step as j_make_step
from moka_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from moka_tpu_torch.train.step import init_train_state, make_train_step

JCFG, CFG = JCfg.tiny(), LlamaConfig.tiny()
JSPEC = JSpec.avt(rank=4, dropout_rate=0.05).with_question_window(8)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.05).with_question_window(8)
TRAIN = dict(learning_rate=1e-2, weight_decay=0.01)
TOTAL = 100  # warmup 3 steps: learning rates 0, 1/3, 2/3 of the peak
LOSS = dict(remat=True, use_flash=True, fused_loss=True, ce_chunk=5)
GRAD = dict(rtol=1e-4, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-5)


class JaxKey:
    """``DropoutKey``'s interface over a ``jax.random`` key."""

    def __init__(self, key):
        self.key = key

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def bits(self, shape, device):
        bits = jax.random.bits(self.key, tuple(shape), jnp.uint16)
        return torch.from_numpy(np.asarray(bits).astype(np.int32)).to(device)

    def bits32(self, shape, device):
        """The uint32 words JAX's fused dropout draws in interpret mode."""
        bits = jax.random.bits(self.key, tuple(shape), jnp.uint32)
        return torch.from_numpy(np.asarray(bits).astype(np.int64)).to(device)


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def world():
    """Tiny fp32 base, adapters with B seeded non-zero, one bench-style
    batch (text / video / audio = 1/2, 1/4, 1/4; question span; a quarter
    of the labels ignored)."""
    r1, r2, r3 = jax.random.split(jax.random.key(0), 3)
    base = jllama.init_llama_params(r1, JCFG, dtype=jnp.float32)
    ad = jllama.init_moka_adapters(r2, JCFG, JSPEC)
    ad = {"layers": {n: {"a": p["a"], "b": jax.random.normal(
        jax.random.fold_in(r3, i), p["b"].shape) * 0.05}
        for i, (n, p) in enumerate(ad["layers"].items())}}
    b, L = 2, 24
    rng = np.random.default_rng(0)
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
    return base, {"adapters": ad}, batch


def _jax_run(world, n_steps, **train):
    """The JAX step ``n_steps`` times: per step (state as numpy, metrics
    with the gradients as numpy)."""
    base, trainable, batch = world
    tx = joptim.make_optimizer(JTrain(**train), total_steps=TOTAL)
    step = j_make_step(j_make_loss(JCFG, JSPEC, **LOSS), tx, donate=False,
                       grad_taps=lambda g: g)
    state = j_init(trainable, tx, jax.random.key(7))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        state, m = step(state, base, jb)
        out.append((_np(dataclasses.replace(state, rng=None)), _np(m)))
    return out


def _port(world, **train):
    base, trainable, batch = world
    tx = toptim.make_optimizer(TrainConfig(**train), total_steps=TOTAL)
    step = make_train_step(make_llama_moka_loss(CFG, SPEC, **LOSS), tx,
                           grad_taps=lambda g: g)
    frozen = params_from_numpy(_np(base), "cpu")
    tb = params_from_numpy(batch, "cpu")
    return tx, step, frozen, tb


def _compare(state, m, jstate, jm):
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(m["supervised_tokens"]) == int(jm["supervised_tokens"])
    jl = jm["grad_taps"]["adapters"]["layers"]
    for name, pair in m["grad_taps"]["adapters"]["layers"].items():
        for ab, g in pair.items():
            np.testing.assert_allclose(g.numpy(), jl[name][ab], **GRAD,
                                       err_msg=f"grad {name}.{ab}")
            np.testing.assert_allclose(
                state.params["adapters"]["layers"][name][ab].numpy(),
                jstate.params["adapters"]["layers"][name][ab], **PARAM,
                err_msg=f"param {name}.{ab}")


@pytest.fixture(scope="module")
def jax_steps(world):
    return _jax_run(world, 3, **TRAIN)


def test_train_steps_match_jax(world, jax_steps):
    """Three steps from the same init: loss, grad norm, every adapter
    gradient and every parameter after each update."""
    tx, step, frozen, tb = _port(world, **TRAIN)
    state = init_train_state(params_from_numpy(_np(world[1]), "cpu"), tx,
                             JaxKey(jax.random.key(7)))
    before = [p.clone() for p in toptim.tree_leaves(state.params)]
    for i, (jstate, jm) in enumerate(jax_steps):
        state, m = step(state, frozen, tb)
        _compare(state, m, jstate, jm)
        assert state.step == i + 1 and state.opt_state.count == i + 1
        moved = any(not torch.equal(a, b) for a, b in
                    zip(before, toptim.tree_leaves(state.params)))
        assert moved == (i > 0)  # step 1 has learning rate 0
    assert not any(p.requires_grad for p in toptim.tree_leaves(state.params))


def test_train_resumes_from_a_jax_state(world, jax_steps):
    """The JAX state after step 2, carried over by ``convert``, then one
    step in the port against JAX's third step."""
    tx, step, frozen, tb = _port(world, **TRAIN)
    key = jax.random.split(jax.random.split(jax.random.key(7))[0])[0]
    state = train_state_from_numpy(jax_steps[1][0], "cpu", JaxKey(key))
    assert state.step == 2 and state.opt_state.count == 2
    state, m = step(state, frozen, tb)
    _compare(state, m, *jax_steps[2])


def test_train_grad_accum_matches_jax(world):
    """``grad_accum=2`` (optax MultiSteps): four micro-steps, parameters
    move on the second and fourth only."""
    train = dict(TRAIN, grad_accum=2)
    runs = _jax_run(world, 4, **train)
    tx, step, frozen, tb = _port(world, **train)
    state = init_train_state(params_from_numpy(_np(world[1]), "cpu"), tx,
                             JaxKey(jax.random.key(7)))
    for i, (jstate, jm) in enumerate(runs):
        state, m = step(state, frozen, tb)
        _compare(state, m, jstate, jm)
        inner = jstate.opt_state.inner_opt_state[1][0]
        assert state.opt_state.count == int(inner.count)
        assert state.opt_state.mini_step == (i + 1) % 2
        for a, ja in zip(toptim.tree_leaves(state.opt_state.acc_grads),
                         jax.tree.leaves(jstate.opt_state.acc_grads)):
            np.testing.assert_allclose(a.numpy(), ja, **GRAD)


def test_train_config_matches_jax():
    tc, jc = TrainConfig(), JTrain()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("total,warmup", [(100, 0.03), (10, 0.0), (1, 0.5)])
def test_schedules_match_optax(kind, total, warmup):
    cfg = dict(lr_schedule=kind, warmup_ratio=warmup, learning_rate=3e-4)
    want = joptim.make_schedule(JTrain(**cfg), total)
    got = toptim.make_schedule(TrainConfig(**cfg), total)
    for count in range(0, total + 5):
        # optax evaluates the schedule in fp32, the port in fp64: a
        # millionth of the peak apart at most (near the cosine's end)
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=3e-10)


@pytest.mark.parametrize("grad_accum", [1, 3])
@pytest.mark.parametrize("max_norm", [1.0, 1e-3])  # never / always clipped
def test_optimizer_matches_optax(grad_accum, max_norm):
    """clip + AdamW (+ MultiSteps) on a random tree, six calls with fresh
    gradients, against ``make_optimizer`` of the JAX package."""
    rng = np.random.default_rng(3)
    params = {"b": {"x": rng.standard_normal((3, 5)).astype(np.float32)},
              "a": rng.standard_normal((4,)).astype(np.float32)}
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.2,
               max_grad_norm=max_norm, grad_accum=grad_accum)
    jtx = joptim.make_optimizer(JTrain(**cfg), total_steps=20)
    ttx = toptim.make_optimizer(TrainConfig(**cfg), total_steps=20)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = ttx.init(tp)
    for _ in range(6):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * 0.3, params)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update(params_from_numpy(g, "cpu"), ts, tp)
        for a, b in zip(toptim.tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(
        float(toptim.global_norm(tp)), float(optax.global_norm(jp)),
        rtol=1e-6)


def test_cross_entropy_matches_jax():
    """Values and d(loss)/d(logits), labels with ignored positions."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 2
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, 2:5] = -100
    want, jg = jax.value_and_grad(jllama.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tllama.cross_entropy_loss(tl, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("rows_layout", [False, True])
@pytest.mark.parametrize("chunk", [4, 64])  # ragged last chunk / one chunk
def test_chunked_cross_entropy_matches_jax(rows_layout, chunk):
    """Chunked lm_head + CE against the JAX scan (value and dX), and
    against the unchunked loss on the full logits."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 10, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 40, (3, 10)).astype(np.int32)
    labels[1, :6] = -100

    def jloss(h_):
        return jllama.chunked_cross_entropy(h_, jnp.asarray(w),
                                            jnp.asarray(labels), chunk=chunk,
                                            rows_layout=rows_layout)

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tllama.chunked_cross_entropy(th, torch.from_numpy(w),
                                       torch.from_numpy(labels), chunk=chunk,
                                       rows_layout=rows_layout)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)
    full = tllama.cross_entropy_loss(
        tllama.head_logits(torch.from_numpy(h), torch.from_numpy(w)),
        torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(full), rtol=1e-5)


@pytest.mark.parametrize("use_flash,fused", [(True, False), (False, True)])
def test_remat_gives_the_same_gradients(world, use_flash, fused):
    """remat=True recomputes every layer in the backward (dropout on): the
    gradients equal those of the run that keeps every activation."""
    from moka_tpu_torch.core.rng import DropoutKey
    base, trainable, batch = world
    frozen = params_from_numpy(_np(base), "cpu")
    tb = params_from_numpy(batch, "cpu")
    grads = []
    for remat in (False, True):
        params = params_from_numpy(_np(trainable), "cpu")
        leaves = toptim.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss_fn = make_llama_moka_loss(CFG, SPEC, remat=remat,
                                       use_flash=use_flash, fused_loss=True,
                                       use_fused_moka=fused, ce_chunk=5)
        loss, _ = loss_fn(params, frozen, tb, DropoutKey(3))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_loss_unported_options_raise():
    for kw in (dict(context_parallel=object()), dict(host_stream={}),
               dict(a8_dots=True), dict(save_q8=True), dict(pallas_ce=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_llama_moka_loss(CFG, SPEC, **kw)
    h = torch.zeros((1, 4, 8))
    with pytest.raises(NotImplementedError, match="kernels 8-9"):
        tllama.chunked_cross_entropy(h, torch.zeros((8, 5)),
                                     torch.zeros((1, 4), dtype=torch.int64),
                                     pallas_ce=True)
