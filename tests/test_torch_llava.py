"""Port parity: the LLaVA (VT) model (``models/llava.py``) against the JAX
package on the CPU, fp32, ``LlavaConfig.tiny()``: the frozen CLIP tower
cut at ``select_layer``, the visual Q-Former projector, the splice at the
image positions and the MokA VT decoder, on one set of numpy weights
(``convert.params_from_numpy``) and one batch laid out by the JAX
package's ``vt_dataset`` (training) or ``benchmarks.build_eval_batch``
(generation).

JAX runs as the package runs it: jitted, flash attention in Pallas
interpret mode.  Tolerances: the features, the embeddings and the loss to
rtol 1e-5; the trainable gradients to the training test's rtol 1e-4 +
atol 1e-6 (``test_torch_train.GRAD``), with ``use_flash`` off and on (the
rule of ``test_torch_unified``, whose extra atol of 1e-8 of the largest
gradient covers the Q-Former's key biases, zero in exact arithmetic);
two ``make_train_step`` steps with LoRA dropout fed JAX's bits
(``JaxKey``) to the same rules and the parameters after them to rtol
1e-4 + atol 1e-5; greedy token ids equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import TrainConfig as JTrain
from moka_tpu.data.benchmarks import build_eval_batch
from moka_tpu.data.vt_dataset import build_vt_sample, collate_vt
from moka_tpu.models import llava as jllava
from moka_tpu.ops import quant as jq
from moka_tpu.train import optim as joptim
from moka_tpu.train.step import init_train_state as j_init
from moka_tpu.train.step import make_train_step as j_make_step
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
from moka_tpu_torch.models import llava as tllava
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.step import init_train_state, make_train_step
from tests.test_datasets import toy_tokenizer
from tests.test_torch_train import PARAM, TOTAL, TRAIN, JaxKey
from tests.test_torch_unified import (_np, assert_grads_match,
                                      jax_loss_and_grads, port_loss_and_grads,
                                      to_port)

PH = 99  # the image placeholder id of the training samples


def configs(dropout=0.0, vocab=256):
    """The JAX and the port's ``LlavaConfig.tiny()`` with LoRA dropout
    ``dropout`` and a vocabulary of ``vocab``."""
    out = []
    for cfg in (jllava.LlavaConfig.tiny(), tllava.LlavaConfig.tiny()):
        out.append(dataclasses.replace(
            cfg, llama=dataclasses.replace(cfg.llama, vocab_size=vocab),
            spec=dataclasses.replace(cfg.spec, dropout_rate=dropout)))
    return out


def make_trees(tcfg):
    """fp32 frozen {llama, clip} and trainable {projector, adapters (B
    non-zero)}, as numpy: drawn by the port's initializers (the JAX
    package's, run eagerly, take seconds a tree; parity never relies on
    either's stream)."""
    g = torch.Generator().manual_seed(0)
    frozen = tllava.init_frozen(g, tcfg, device="cpu", dtype=torch.float32)
    trainable = tllava.init_trainable(g, tcfg, device="cpu")
    for p in trainable["adapters"]["layers"].values():
        p["b"].normal_(0.0, 0.05, generator=g)

    def np_tree(tree):
        if isinstance(tree, dict):
            return {k: np_tree(v) for k, v in tree.items()}
        return tree.numpy()

    return np_tree(frozen), np_tree(trainable)


def train_batch(jcfg, b=2, L=24, seed=0):
    """``bench.py::run_vt``'s samples (prefix, the image placeholders, a
    question, an answer), right-padded to L with shared positions."""
    nq = jcfg.projector.num_query_tokens
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(b):
        pre = rng.integers(4, 90, 3 + i).tolist()
        q = rng.integers(4, 90, 5).tolist()
        ans = rng.integers(4, 90, 6 - 2 * i).tolist()
        ids = np.asarray(pre + [PH] * nq + q + ans)
        labels = np.asarray([-100] * (len(pre) + nq + len(q)) + ans)
        samples.append(build_vt_sample(ids, labels, PH, 0,
                                       num_image_tokens=nq))
    batch = collate_vt(samples, pad_id=0, pad_to=L)
    img = jcfg.clip.image_size
    batch["pixel_values"] = rng.standard_normal(
        (b, 3, img, img)).astype(np.float32)
    return batch


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = configs()
    frozen, trainable = make_trees(tcfg)
    return jcfg, tcfg, frozen, trainable, train_batch(jcfg)


def test_select_layer_stops_the_tower_before_its_last_layer():
    for j, t in ((jllava.LlavaConfig.vt_7b(), tllava.LlavaConfig.vt_7b()),
                 (jllava.LlavaConfig.tiny(), tllava.LlavaConfig.tiny())):
        assert t.select_layer == j.select_layer
        assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert tllava.LlavaConfig.vt_7b().select_layer == 23


def test_jax_trees_convert_with_no_renaming():
    """JAX's LLaVA trees (frozen {llama, clip}, trainable {projector,
    adapters}; shapes from ``jax.eval_shape``) carried across by
    ``params_from_numpy`` have the port's keys, shapes and dtypes."""
    jcfg, tcfg = configs()
    g = torch.Generator().manual_seed(1)
    for jinit, tree in (
            (lambda k: jllava.init_frozen(k, jcfg, dtype=jnp.float32),
             tllava.init_frozen(g, tcfg, device="cpu", dtype=torch.float32)),
            (lambda k: jllava.init_trainable(k, jcfg),
             tllava.init_trainable(g, tcfg, device="cpu"))):
        shapes = jax.eval_shape(jinit, jax.random.key(0))
        got = params_from_numpy(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
        jpaths = jax.tree_util.tree_flatten_with_path(got)[0]
        tpaths = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [jax.tree_util.keystr(p) for p, _ in jpaths] == \
            [jax.tree_util.keystr(p) for p, _ in tpaths]
        for (path, a), (_, b) in zip(jpaths, tpaths):
            assert (a.shape, a.dtype) == (b.shape, b.dtype), \
                jax.tree_util.keystr(path)


def test_image_features_and_embeds_match_jax(world):
    jcfg, tcfg, frozen, trainable, batch = world
    want_f = jllava.image_features(trainable, frozen, jcfg,
                                   jnp.asarray(batch["pixel_values"]))
    want_e = jllava.build_inputs_embeds(trainable, frozen, jcfg,
                                        jnp_batch(batch))
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    feats = tllava.image_features(ttrain, tfrozen, tcfg,
                                  tbatch["pixel_values"])
    assert feats.shape == (2, tcfg.projector.num_query_tokens,
                           tcfg.llama.dim)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f),
                               rtol=1e-5, atol=1e-6)
    embeds = tllava.build_inputs_embeds(ttrain, tfrozen, tcfg, tbatch)
    np.testing.assert_allclose(embeds.numpy(), np.asarray(want_e),
                               rtol=1e-5, atol=1e-6)


def test_tower_keeps_no_graph(world):
    """The frozen tower runs without autograd: the features' graph starts
    at the projector, whose parameters alone receive their gradient."""
    _, tcfg, frozen, trainable, batch = world
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    for t in toptim.tree_leaves(tfrozen["clip"]):
        t.requires_grad_(True)
    for t in toptim.tree_leaves(ttrain["projector"]):
        t.requires_grad_(True)
    feats = tllava.image_features(ttrain, tfrozen, tcfg,
                                  tbatch["pixel_values"])
    grads = torch.autograd.grad(feats.sum(), tfrozen["clip"]["patch"],
                                allow_unused=True)
    assert grads == (None,) and feats.requires_grad


def test_quantized_tower_and_base_embeds_match_jax(world):
    """An int8 CLIP tower and an int4 LLaMA base carried across by
    ``params_from_numpy`` (codes and fp32 scales kept): the spliced
    embeddings to rtol 1e-5."""
    jcfg, tcfg, frozen, trainable, batch = world
    qfrozen = {"clip": _np(jq.quantize_encoder(frozen["clip"], min_dim=16)),
               "llama": _np(jq.quantize_llama_base(frozen["llama"],
                                                   bits=4))}
    want = jllava.build_inputs_embeds(trainable, qfrozen, jcfg,
                                      jnp_batch(batch))
    tfrozen, ttrain, tbatch = to_port(qfrozen, trainable, batch)
    assert tfrozen["clip"]["layers"]["q"]["w"]["w_i8"].dtype == torch.int8
    got = tllava.build_inputs_embeds(ttrain, tfrozen, tcfg, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("use_flash", [False, True])
def test_llava_loss_and_every_gradient_match_jax(world, use_flash):
    jcfg, tcfg, frozen, trainable, batch = world
    kw = dict(remat=True, use_flash=use_flash, fused_loss=True)
    loss, metrics, grads = port_loss_and_grads(
        tllava.llava_loss(tcfg, **kw), *to_port(frozen, trainable, batch))
    jloss, jmetrics, jgrads = jax_loss_and_grads(
        jllava.llava_loss(jcfg, **kw), frozen, trainable, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert int(metrics["supervised_tokens"]) == \
        int(jmetrics["supervised_tokens"]) == 6 + 4
    assert_grads_match(grads, jgrads)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g in zip(names, grads):
        unused = "word_embed" in name or "pos_embed" in name or \
            "ffn_t_" in name
        assert bool((g == 0).all()) == unused, name


def test_train_steps_match_jax():
    """Two steps (remat, flash, the chunked CE) with LoRA dropout 0.05:
    loss, global norm and every trainable gradient each step, then every
    parameter after the update."""
    jcfg, tcfg = configs(dropout=0.05)
    frozen, trainable = make_trees(tcfg)
    batch = train_batch(jcfg, seed=1)
    loss = dict(remat=True, use_flash=True, fused_loss=True)
    jtx = joptim.make_optimizer(JTrain(**TRAIN), total_steps=TOTAL)
    jstep = j_make_step(jllava.llava_loss(jcfg, **loss), jtx, donate=False,
                        grad_taps=lambda g: g)
    jstate = j_init(jax.tree.map(jnp.asarray, trainable), jtx,
                    jax.random.key(7))
    tx = toptim.make_optimizer(TrainConfig(**TRAIN), total_steps=TOTAL)
    step = make_train_step(tllava.llava_loss(tcfg, **loss), tx,
                           grad_taps=lambda g: g)
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    state = init_train_state(ttrain, tx, JaxKey(jax.random.key(7)))
    jb = jnp_batch(batch)
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
    """A left-padded eval batch from ``build_eval_batch``: three prompts
    of other lengths, each with an image, over the toy word tokenizer
    (ids up to 1010, so a vocabulary of 1024)."""
    jcfg, tcfg = configs(vocab=1024)
    frozen, trainable = make_trees(tcfg)
    rng = np.random.default_rng(3)
    img = jcfg.clip.image_size
    items = [{"prompt": "This is an image:\n<image_start><image><image_end>"
              "\n" + " ".join(f"w{j}" for j in range(2 + 3 * i)),
              "image": rng.standard_normal((3, img, img)).astype(
                  np.float32)} for i in range(3)]
    batch = build_eval_batch(items, toy_tokenizer(),
                             jcfg.projector.num_query_tokens)
    return jcfg, tcfg, frozen, trainable, batch


def test_generate_greedy_tokens_match_jax(prompts):
    jcfg, tcfg, frozen, trainable, batch = prompts
    assert (batch["attn_mask"][:, -1] == 1).all()
    assert len(set(batch["attn_mask"].sum(axis=1).tolist())) == 3
    want = np.asarray(jllava.generate(trainable, frozen, jcfg,
                                      jnp_batch(batch), max_new_tokens=4,
                                      eos_id=10 ** 9))
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    got = tllava.generate(ttrain, tfrozen, tcfg, tbatch, max_new_tokens=4,
                          eos_id=10 ** 9)
    assert got.dtype == torch.int32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_kv_quant_raises(prompts):
    """The int8 cache is ported (it raised before): generation with
    ``kv_quant`` gives JAX's greedy ids exactly."""
    jcfg, tcfg, frozen, trainable, batch = prompts
    want = np.asarray(jllava.generate(trainable, frozen, jcfg,
                                      jnp_batch(batch), max_new_tokens=4,
                                      eos_id=10 ** 9, kv_quant=True))
    tfrozen, ttrain, tbatch = to_port(frozen, trainable, batch)
    got = tllava.generate(ttrain, tfrozen, tcfg, tbatch, max_new_tokens=4,
                          eos_id=10 ** 9, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tllava.LlavaConfig.tiny()
    g = torch.Generator()
    for call in (lambda: tllava.init_frozen(g, cfg),
                 lambda: tllava.init_trainable(g, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    frozen = tllava.init_frozen(g, cfg, device="cpu", dtype=torch.float32)
    trainable = tllava.init_trainable(g, cfg, device="cpu")
    assert sorted(frozen) == ["clip", "llama"]
    assert sorted(trainable) == ["adapters", "projector"]
    assert trainable["adapters"]["layers"]["q"]["a"].shape == \
        (LlamaConfig.tiny().n_layers, 2, 64, 4)
