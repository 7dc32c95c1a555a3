"""Port parity: the tri-modal AVT model (``models/unified.py``) against the
JAX package on the CPU, fp32, ``UnifiedConfig.tiny()``: the CLIP and BEATs
towers, both Q-Former projectors, the splice and the MokA decoder, on one
set of numpy weights (``convert.params_from_numpy``) and one batch laid
out as ``bench.py::run_multimodal`` lays it out.

JAX runs as the package runs it: jitted, flash attention in Pallas
interpret mode.  Tolerances: the loss to rtol 1e-5; the adapters'
gradients at the training test's rtol 1e-4 + atol 1e-6
(``test_torch_train.GRAD``); every other trainable leaf (both projectors,
``new_token_embeds``) to rtol 1e-4 plus an atol of 1e-4 of the leaf's
largest element and 1e-8 of the largest gradient of any leaf (the key
biases of the Q-Formers' attentions have zero gradients in exact
arithmetic and are rounding noise on both sides): fp32 on both sides, the
projector gradients summed through more layers in other orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.data import assembler as jasm
from moka_tpu.models import unified as junified
from moka_tpu.ops import quant as jq
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.models import unified as tunified
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.train.optim import tree_leaves
from tests.test_torch_train import GRAD

N_VIDEO, N_AUDIO, FRAMES = 2, 2, 32  # groups a sample; fbank frames a group
LOSS = dict(remat=True, use_flash=True, fused_loss=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def configs(dropout=0.0):
    """The JAX and the port's ``UnifiedConfig.tiny()`` with a question
    window of 16 and ``dropout``."""
    jspec = JSpec.avt(rank=4, dropout_rate=dropout).with_question_window(16)
    spec = MokaSpec.avt(rank=4, dropout_rate=dropout).with_question_window(
        16)
    return junified.UnifiedConfig.tiny(jspec), \
        tunified.UnifiedConfig.tiny(spec)


def make_batch(jcfg, b=2, L=56, seed=0, answers=True):
    """bench.py's sample layout (prefix, <video>, <audio>, question,
    answer) over ``N_VIDEO`` frames and ``N_AUDIO`` fbank segments,
    left-padded to L; without ``answers``, the eval prompt layout."""
    nv = N_VIDEO * jcfg.vl_projector.num_query_tokens
    na = N_AUDIO * jcfg.al_projector.num_query_tokens
    base = jcfg.llama.vocab_size - len(jasm.SPECIAL_TOKENS)
    t2i = {t: base + i for i, t in enumerate(jasm.SPECIAL_TOKENS)}
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(b):
        prefix = rng.integers(4, base, 6 + i).tolist()
        q_toks = rng.integers(4, base, 6).tolist()
        answer = rng.integers(4, base, 8 - 2 * i).tolist() if answers else []
        ids = (prefix
               + [t2i["<video_start>"], t2i["<video>"], t2i["<video_end>"]]
               + [t2i["<audio_start>"], t2i["<audio>"], t2i["<audio_end>"]]
               + [t2i["<question_start>"]] + q_toks
               + [t2i["<question_end>"]] + answer)
        lab = [-100] * (len(ids) - len(answer)) + answer
        samples.append(jasm.assemble_sample(
            np.asarray(ids), np.asarray(lab), t2i, pad_id=0,
            n_video_tokens=nv, n_audio_tokens=na))
    batch = jasm.pad_batch(samples, pad_id=0, pad_to=L if answers else None)
    img = jcfg.clip.image_size
    batch["video"] = rng.standard_normal(
        (b, N_VIDEO, 3, img, img)).astype(np.float32)
    batch["audio"] = rng.standard_normal(
        (b, N_AUDIO, FRAMES, 128)).astype(np.float32)
    return batch


def make_trees(jcfg, n_new=len(jasm.SPECIAL_TOKENS), with_adapters=True):
    """fp32 frozen {llama, clip, beats} and trainable {adapters (B
    non-zero), vl_projector, al_projector, new_token_embeds}, as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    frozen = junified.init_frozen(k1, jcfg, dtype=jnp.float32)
    trainable = junified.init_trainable(k2, jcfg, with_adapters=with_adapters,
                                        n_new_token_embeds=n_new,
                                        frozen=frozen)
    if with_adapters:
        layers = trainable["adapters"]["layers"]
        for i, name in enumerate(sorted(layers)):
            layers[name]["b"] = jax.random.normal(
                jax.random.fold_in(k3, i), layers[name]["b"].shape) * 0.05
    return _np(frozen), _np(trainable)


def to_port(frozen, trainable, batch):
    return (params_from_numpy(frozen, "cpu"),
            params_from_numpy(trainable, "cpu"),
            params_from_numpy(batch, "cpu"))


def jax_loss_and_grads(loss_fn, frozen, trainable, batch):
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, metrics), grads = fn(trainable, frozen,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.key(1))
    return float(loss), _np(metrics), _np(grads)


def port_loss_and_grads(loss_fn, frozen, trainable, batch):
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(trainable, frozen, batch, None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), metrics, grads


def assert_grads_match(grads, jgrads):
    """``grads`` in ``tree_leaves`` order against JAX's gradient tree."""
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(grads)
    scale = max(np.abs(np.asarray(g)).max() for _, g in flat)
    for g, (path, jg) in zip(grads, flat):
        name = jax.tree_util.keystr(path)
        jg = np.asarray(jg)
        if name.startswith("['adapters']"):
            tol = GRAD
        else:
            tol = dict(rtol=1e-4, atol=1e-4 * np.abs(jg).max() +
                       1e-8 * scale)
        np.testing.assert_allclose(g.numpy(), jg, err_msg=name, **tol)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = configs()
    frozen, trainable = make_trees(jcfg)
    return jcfg, tcfg, frozen, trainable, make_batch(jcfg)


def test_batch_layout(world):
    """The batch holds every feature span and a supervised answer."""
    jcfg, _, _, _, batch = world
    assert batch["video_pos"].shape == (2, N_VIDEO * 4)
    assert batch["audio_pos"].shape == (2, N_AUDIO * 4)
    assert batch["ids"].shape == (2, 56)
    assert (batch["labels"] != -100).sum() == 8 + 6


@pytest.mark.parametrize("stage", [2, 1])
def test_unified_loss_and_every_gradient_match_jax(world, stage):
    """Stage 2 (adapters and projectors) and stage 1
    (``train_adapters=False``: the decoder without adapter deltas, whose
    adapters then get zero gradients on both sides)."""
    jcfg, tcfg, frozen, trainable, batch = world
    kw = dict(LOSS, train_adapters=stage == 2)
    loss, metrics, grads = port_loss_and_grads(
        tunified.unified_loss(tcfg, **kw), *to_port(frozen, trainable, batch))
    jloss, jmetrics, jgrads = jax_loss_and_grads(
        junified.unified_loss(jcfg, **kw), frozen, trainable, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert int(metrics["supervised_tokens"]) == \
        int(jmetrics["supervised_tokens"])
    assert_grads_match(grads, jgrads)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g in zip(names, grads):
        unused = "word_embed" in name or "pos_embed" in name or \
            "ffn_t_" in name or (stage == 1 and "adapters" in name)
        assert bool((g == 0).all()) == unused, name


def test_build_inputs_embeds_on_quantized_towers_matches_jax(world):
    """int8 towers (weight-only, W8A8 off) and an int8 LLaMA base carried
    across by ``params_from_numpy``, quantized leaves kept as they are
    (codes, fp32 scales) even when a float dtype is asked for; the
    spliced embeddings to rtol 1e-5."""
    jcfg, tcfg, frozen, trainable, batch = world
    qfrozen = dict(frozen)
    qfrozen["clip"] = _np(jq.quantize_encoder(frozen["clip"], min_dim=16))
    qfrozen["beats"] = _np(jq.quantize_encoder(frozen["beats"], min_dim=16))
    qfrozen["llama"] = _np(jq.quantize_llama_base(frozen["llama"], bits=8))
    want = junified.build_inputs_embeds(
        trainable, qfrozen, jcfg, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    tfrozen = params_from_numpy(qfrozen, "cpu", dtype=torch.float32)
    q = tfrozen["clip"]["layers"]["fc1"]["w"]
    assert q["w_i8"].dtype == torch.int8 and q["scale"].dtype == \
        torch.float32
    assert tfrozen["beats"]["patch_bias"] is None
    half = params_from_numpy(qfrozen["clip"], "cpu", dtype=torch.bfloat16)
    q = half["layers"]["fc1"]["w"]
    assert q["w_i8"].dtype == torch.int8 and q["scale"].dtype == \
        torch.float32 and half["patch"].dtype == torch.bfloat16
    got = tunified.build_inputs_embeds(
        params_from_numpy(trainable, "cpu"), tfrozen, tcfg,
        params_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tcfg = configs()
    g = torch.Generator()
    for call in (lambda: tunified.init_frozen(g, tcfg),
                 lambda: tunified.init_trainable(g, tcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    trainable = tunified.init_trainable(g, tcfg, n_new_token_embeds=3,
                                        device="cpu")
    assert sorted(trainable) == ["adapters", "al_projector",
                                 "new_token_embeds", "vl_projector"]
    assert trainable["new_token_embeds"].dtype == torch.float32
