"""Port parity: the named remat policies (``models.llama.REMAT_POLICIES``)
and the fine-tune step with fused dropout under ``proj_lse``, against the
JAX package on the CPU, fp32, ``LlamaConfig.tiny()``.

JAX's ``jax.checkpoint`` keeps the tensors a policy names and lets XLA drop
the rest of the recompute that no backward reads; the port keeps the same
tensors (``_RematSaves``) and must redo the same work.  The work is counted
inside the backward only: frozen projection products (by their weight
operands, with a ``TorchDispatchMode``) and flash forwards (calls of the
plain flash forward, which CPU tensors run).

Tolerances: gradients under a policy equal the port's gradients without
remat to 1e-6 relative (the recompute redoes the same fp32 arithmetic);
against JAX's gradients under the same policy, JAX's own test tolerance
(``tests/test_llama.py``: 2e-4 relative + 1e-6).  The three-step test uses
``tests/test_torch_train.py``'s tolerances.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from moka_tpu.core.config import LlamaConfig as JCfg, TrainConfig as JTrain
from moka_tpu.models import llama as jllama
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu.train import optim as joptim
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu.train.step import init_train_state as j_init
from moka_tpu.train.step import make_train_step as j_make_step
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.ops import flash_attention as fa
from moka_tpu_torch.ops import fused_dropout as fd
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from moka_tpu_torch.train.step import init_train_state, make_train_step
from tests.test_torch_train import (GRAD, TOTAL, TRAIN, JaxKey, _compare,
                                    _np, world)  # noqa: F401 (world: a fixture)

JCFG, CFG = JCfg.tiny(), LlamaConfig.tiny()
JSPEC = JSpec.avt(rank=4, dropout_rate=0.05).with_question_window(8) \
    .with_fused_dropout()
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.05).with_question_window(8) \
    .with_fused_dropout()
POLICIES = ("full", "attn", "qkv", "qkvod", "qkvod_lse", "mlp", "proj",
            "proj_nokv", "proj_nokv_lse", "proj_noqkv", "proj_lse", "dots")
# per layer, inside the backward: (frozen products of q, k, v, o, gate, up
# that rerun, flash forwards that rerun).  The down product never reruns:
# no backward of its layer reads its output, and XLA drops it from JAX's
# recompute too (test_recompute_matches_jax_hlo).
RECOMPUTE = {"full": (6, 1), "attn": (6, 1), "qkv": (3, 1), "qkvod": (2, 1),
             "qkvod_lse": (2, 0), "mlp": (4, 1), "proj": (0, 1),
             "proj_nokv": (2, 1), "proj_nokv_lse": (2, 0),
             "proj_noqkv": (3, 1), "proj_lse": (0, 0), "dots": (0, 1)}
LOSS = dict(fused_loss=True, ce_chunk=5)


def _policy(name):
    return None if name == "full" else name


def test_policy_names_and_save_sets_match_jax():
    """The same policy names (JAX's ``_remat_policy`` accepts each, and
    rejects what the port rejects), the same per-policy projection sets
    and ``_resolve_save_q8`` results."""
    assert set(tllama.REMAT_POLICIES) == set(POLICIES) | {None}
    for name in tllama.REMAT_POLICIES:
        jllama._remat_policy(name)
    for module in (jllama, tllama):
        with pytest.raises(ValueError, match="unknown remat policy"):
            module._remat_policy("nope")
    assert tllama._POLICY_SAVED_PROJS == jllama._POLICY_SAVED_PROJS
    for name, projs in tllama._POLICY_SAVED_PROJS.items():
        kept = tllama.REMAT_POLICIES[name]
        assert {p for p in tllama.PROJ_DIMS if f"proj_{p}" in kept} == \
            set(projs)
    for policy in (None, "proj", "qkvod_lse", "nope"):
        for sq8 in (False, True, "fp8", ("q", "up"), ("fp8", "down")):
            assert tllama._resolve_save_q8(sq8, policy) == \
                jllama._resolve_save_q8(sq8, policy)


def _grads(world, policy, use_flash, key):
    """The port's adapter gradients (a flat list) for one loss call."""
    base, trainable, batch = world
    frozen = params_from_numpy(_np(base), "cpu")
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = make_llama_moka_loss(CFG, SPEC, remat=policy is not False,
                                   remat_policy=_policy(policy or "full"),
                                   use_flash=use_flash, **LOSS)
    loss, _ = loss_fn(params, frozen, params_from_numpy(batch, "cpu"), key)
    return torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def no_remat_grads(world):
    return {f: _grads(world, False, f, JaxKey(jax.random.key(7)))
            for f in (False, True)}


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_grads_match_no_remat_and_jax(world, no_remat_grads, policy,
                                             use_flash):
    """Every policy, flash on and off, fused dropout on: the port's
    gradients equal its no-remat gradients and JAX's under the same
    policy."""
    base, trainable, batch = world
    got = _grads(world, policy, use_flash, JaxKey(jax.random.key(7)))
    for a, b in zip(got, no_remat_grads[use_flash]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
    j_loss = j_make_loss(JCFG, JSPEC, remat=True,
                         remat_policy=_policy(policy), use_flash=use_flash,
                         **LOSS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(jax.grad(lambda tr: j_loss(tr, base, jb,
                                              jax.random.key(7))[0]))(
        trainable)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-6, err_msg=f"{policy} {path}")


class _CountFrozen(TorchDispatchMode):
    """Counts matrix products whose right operand is one of ``weights`` as
    stored (the frozen products; the backward's dX uses them transposed)."""

    def __init__(self, weights):
        super().__init__()
        self.weights = {(w.data_ptr(), tuple(w.shape), w.stride())
                        for w in weights}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            w = args[1]
            self.count += (w.data_ptr(), tuple(w.shape), w.stride()) in \
                self.weights
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_counts(world, policy, monkeypatch):
    """Inside the backward, per layer: the frozen products and flash
    forwards each policy reruns (``RECOMPUTE``); the forward ran each of
    the seven products and one flash forward per layer once."""
    base, trainable, batch = world
    frozen = params_from_numpy(_np(base), "cpu")
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    flash = [0]
    plain = fa.flash_fwd_plain

    def counted(*args, **kw):
        flash[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_fwd_plain", counted)
    weights = [frozen["layers"][n][i] for n in tllama.PROJ_DIMS
               for i in range(CFG.n_layers)]
    loss_fn = make_llama_moka_loss(CFG, SPEC, remat=True,
                                   remat_policy=_policy(policy),
                                   use_flash=True, **LOSS)
    with _CountFrozen(weights) as fwd:
        loss, _ = loss_fn(params, frozen, params_from_numpy(batch, "cpu"),
                          DropoutKey(3))
    assert (fwd.count, flash[0]) == (7 * CFG.n_layers, CFG.n_layers)
    flash[0] = 0
    with _CountFrozen(weights) as bwd:
        torch.autograd.grad(loss, leaves)
    products, flashes = RECOMPUTE[policy]
    assert (bwd.count, flash[0]) == (products * CFG.n_layers,
                                     flashes * CFG.n_layers)


@pytest.mark.parametrize("policy", POLICIES)
def test_every_kept_tensor_is_read_in_the_recompute(world, policy,
                                                    monkeypatch):
    """What a layer's ``_RematSaves`` keeps, its recompute reads: JAX keeps
    only the tagged values some backward reads, so a kept tensor that is
    never read would hold memory JAX does not.  The kept set is the
    policy's tags less ``proj_down`` (the recompute stops before the down
    product)."""
    base, trainable, batch = world
    frozen = params_from_numpy(_np(base), "cpu")
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    class Logged(dict):
        def __init__(self):
            super().__init__()
            self.read = set()

        def __getitem__(self, tag):
            self.read.add(tag)
            return super().__getitem__(tag)

    layers = []

    class Saves(tllama._RematSaves):
        def __init__(self, names):
            super().__init__(names)
            self.kept = Logged()
            layers.append(self)

    monkeypatch.setattr(tllama, "_RematSaves", Saves)
    loss_fn = make_llama_moka_loss(CFG, SPEC, remat=True,
                                   remat_policy=_policy(policy),
                                   use_flash=True, **LOSS)
    loss, _ = loss_fn(params, frozen, params_from_numpy(batch, "cpu"),
                      DropoutKey(5))
    assert len(layers) == CFG.n_layers
    want = set(tllama.REMAT_POLICIES[_policy(policy)]) - {"proj_down"}
    for s in layers:
        assert set(s.kept) == want and not s.kept.read
    torch.autograd.grad(loss, leaves)
    for s in layers:
        assert s.kept.read == want


def _jax_recomputed_dots(policy):
    """Dot products JAX's compiled gradient of one tiny layer (no adapters,
    flash in interpret mode) has beyond the no-remat gradient's."""
    cfg = JCfg.tiny(n_layers=1)
    base = jllama.init_llama_params(jax.random.key(0), cfg, dtype=jnp.float32)
    h0 = jnp.full((2, 16, cfg.dim), 0.1, jnp.float32)

    def n_dots(remat, pol):
        def loss(h):
            out, _ = jllama.forward(base, cfg, inputs_embeds=h, remat=remat,
                                    remat_policy=pol, use_flash=True,
                                    logits=False)
            return jnp.sum(out ** 2)
        text = jax.jit(jax.grad(loss)).lower(h0).compile().as_text()
        return sum(" dot(" in line for line in text.splitlines())

    return n_dots(True, _policy(policy)) - n_dots(False, None)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_jax_hlo(policy):
    """``RECOMPUTE`` is JAX's: XLA's compiled gradient of a layer holds, per
    rerun frozen product, one more dot, and per rerun flash forward two (the
    interpret-mode kernel's two products)."""
    products, flashes = RECOMPUTE[policy]
    assert _jax_recomputed_dots(policy) == products + 2 * flashes


def test_dropout_masks_are_identical_in_the_recompute(world, monkeypatch):
    """Under ``proj_lse`` every key's words drawn in the backward (the
    recompute's forward kernel and the backward kernel) equal the words the
    forward drew for that key."""
    base, trainable, batch = world
    frozen = params_from_numpy(_np(base), "cpu")
    params = params_from_numpy(_np(trainable), "cpu")
    leaves = toptim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    draws = {"fwd": [], "bwd": []}
    phase = ["fwd"]
    bits32 = DropoutKey.bits32

    def logged(self, shape, device):
        out = bits32(self, shape, device)
        draws[phase[0]].append((self.seed, out))
        return out

    monkeypatch.setattr(DropoutKey, "bits32", logged)
    loss_fn = make_llama_moka_loss(CFG, SPEC, remat=True,
                                   remat_policy="proj_lse", use_flash=True,
                                   **LOSS)
    loss, _ = loss_fn(params, frozen, params_from_numpy(batch, "cpu"),
                      DropoutKey(8))
    phase[0] = "bwd"
    torch.autograd.grad(loss, leaves)
    forward = dict(draws["fwd"])
    assert len(forward) == len(draws["fwd"]) == 7 * CFG.n_layers
    assert len(draws["bwd"]) == 2 * len(forward)
    assert sorted(s for s, _ in draws["bwd"]) == sorted(2 * list(forward))
    for seed, words in draws["bwd"]:
        assert torch.equal(words, forward[seed])


def _jax_run(world, n_steps):
    base, trainable, batch = world
    tx = joptim.make_optimizer(JTrain(**TRAIN), total_steps=TOTAL)
    loss = j_make_loss(JCFG, JSPEC, remat=True, remat_policy="proj_lse",
                       use_flash=True, **LOSS)
    step = j_make_step(loss, tx, donate=False, grad_taps=lambda g: g)
    state = j_init(trainable, tx, jax.random.key(7))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        state, m = step(state, base, jb)
        out.append((_np(dataclasses.replace(state, rng=None)), _np(m)))
    return out, state


def test_train_steps_fused_dropout_proj_lse_match_jax(world):
    """Three jitted JAX steps with fused dropout under ``proj_lse`` against
    the port's: loss, grad norm, every gradient and parameter after each
    update, and the AdamW moments after the third."""
    runs, jstate = _jax_run(world, 3)
    base, trainable, batch = world
    tx = toptim.make_optimizer(TrainConfig(**TRAIN), total_steps=TOTAL)
    loss = make_llama_moka_loss(CFG, SPEC, remat=True,
                                remat_policy="proj_lse", use_flash=True,
                                **LOSS)
    step = make_train_step(loss, tx, grad_taps=lambda g: g)
    state = init_train_state(params_from_numpy(_np(trainable), "cpu"), tx,
                             JaxKey(jax.random.key(7)))
    frozen = params_from_numpy(_np(base), "cpu")
    tb = params_from_numpy(batch, "cpu")
    before = (fd.dropout_a_fwd.launches, fd.dropout_a_bwd.launches)
    for i, (js, jm) in enumerate(runs):
        state, m = step(state, frozen, tb)
        _compare(state, m, js, jm)
        assert state.step == i + 1 and state.opt_state.count == i + 1
    adam = jstate.opt_state[1][0]  # optax chain: (clip, (adam, ...))
    for a, b in zip(toptim.tree_leaves(state.opt_state.mu),
                    jax.tree.leaves(adam.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
    for a, b in zip(toptim.tree_leaves(state.opt_state.nu),
                    jax.tree.leaves(adam.nu)):  # the gradients' RMS
        np.testing.assert_allclose(a.sqrt().numpy(), np.sqrt(np.asarray(b)),
                                   **GRAD)
    assert (fd.dropout_a_fwd.launches, fd.dropout_a_bwd.launches) == before
