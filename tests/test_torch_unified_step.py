"""Port parity: the multimodal fine-tune step and multimodal generation
(``models/unified.py`` through ``train/step.py`` and ``eval/decode.py``)
against the JAX package on the CPU, fp32, ``UnifiedConfig.tiny()``.

The step runs the shipping multimodal policy ``qkvod_lse`` with LoRA
dropout 0.05; the port's key is ``test_torch_train.JaxKey``, which draws
JAX's bits along the same path, so both drop the same inputs.  Tolerances
as ``test_torch_unified``: the loss and the global norm to rtol 1e-5,
the gradients leaf by leaf, the parameters after the second step (the
first has learning rate 0) to the training test's rtol 1e-4 + atol 1e-5.
Generation: greedy token ids equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import TrainConfig as JTrain
from moka_tpu.models import unified as junified
from moka_tpu.train import optim as joptim
from moka_tpu.train.step import init_train_state as j_init
from moka_tpu.train.step import make_train_step as j_make_step
from moka_tpu_torch.core.config import TrainConfig
from moka_tpu_torch.models import unified as tunified
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.step import init_train_state, make_train_step
from tests.test_torch_train import PARAM, TOTAL, TRAIN, JaxKey
from tests.test_torch_unified import (LOSS, _np, assert_grads_match,
                                      configs, make_batch, make_trees,
                                      to_port)


def test_train_steps_match_jax():
    """Two steps under ``qkvod_lse`` with dropout: loss, global norm and
    every trainable gradient each step (the Q-Formers' unused text branch
    gets zeros on both sides, which AdamW's moments and the norm see),
    then every parameter after the update."""
    jcfg, tcfg = configs(dropout=0.05)
    frozen, trainable = make_trees(jcfg)
    batch = make_batch(jcfg, seed=1)
    loss = dict(LOSS, remat_policy="qkvod_lse")
    jtx = joptim.make_optimizer(JTrain(**TRAIN), total_steps=TOTAL)
    jstep = j_make_step(junified.unified_loss(jcfg, **loss), jtx,
                        donate=False, grad_taps=lambda g: g)
    jstate = j_init(jax.tree.map(jnp.asarray, trainable), jtx,
                    jax.random.key(7))
    tx = toptim.make_optimizer(TrainConfig(**TRAIN), total_steps=TOTAL)
    step = make_train_step(tunified.unified_loss(tcfg, **loss), tx,
                           grad_taps=lambda g: g)
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    state = init_train_state(ttrain, tx, JaxKey(jax.random.key(7)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jm = jstep(jstate, frozen, jb)
        state, m = step(state, tfrozen, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert_grads_match(toptim.tree_leaves(m["grad_taps"]),
                           _np(jm["grad_taps"]))
    jleaves = jax.tree_util.tree_flatten_with_path(_np(jstate.params))[0]
    for p, (path, jp) in zip(toptim.tree_leaves(state.params), jleaves):
        np.testing.assert_allclose(p.numpy(), jp,
                                   err_msg=jax.tree_util.keystr(path),
                                   **PARAM)
    assert state.opt_state.count == 2


@pytest.fixture(scope="module")
def prompts():
    jcfg, tcfg = configs()
    frozen, trainable = make_trees(jcfg)
    return jcfg, tcfg, frozen, trainable, make_batch(jcfg, b=3,
                                                     answers=False)


def test_generate_greedy_tokens_match_jax(prompts):
    jcfg, tcfg, frozen, trainable, batch = prompts
    want = np.asarray(junified.generate(
        trainable, frozen, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()},
        max_new_tokens=4, eos_id=10 ** 9))
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    got = tunified.generate(ttrain, tfrozen, tcfg, tbatch, max_new_tokens=4,
                            eos_id=10 ** 9)
    assert got.dtype == torch.int32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampled_rows_and_kv_quant(prompts):
    """Per-row temperatures: a row at 0 decodes greedily, a sampled row
    stays in the vocabulary and follows its generator; the int8 cache
    (ported; it raised before) gives JAX's greedy ids."""
    jcfg, tcfg, frozen, trainable, batch = prompts
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    greedy = tunified.generate(ttrain, tfrozen, tcfg, tbatch,
                               max_new_tokens=4, eos_id=10 ** 9)

    def sampled(seed):
        return tunified.generate(
            ttrain, tfrozen, tcfg, tbatch, max_new_tokens=4, eos_id=10 ** 9,
            temperature=torch.tensor([0.0, 1.5, 1.5]), top_k=50,
            generator=torch.Generator().manual_seed(seed))

    a, b = sampled(0), sampled(0)
    assert torch.equal(a, b) and torch.equal(a[0], greedy[0])
    assert 0 <= int(a.min()) and int(a.max()) < tcfg.llama.vocab_size
    want = np.asarray(junified.generate(
        trainable, frozen, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, max_new_tokens=4,
        eos_id=10 ** 9, kv_quant=True))
    got = tunified.generate(ttrain, tfrozen, tcfg, tbatch, max_new_tokens=4,
                            eos_id=10 ** 9, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), want)
