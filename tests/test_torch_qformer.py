"""Port parity: the Q-Former (``models/qformer.py``) and the VL / AL
projectors (``models/projectors.py``) against the JAX package on the CPU,
fp32, same numpy weights and inputs.

Tolerances: outputs and the gradients of every projector leaf to rtol
1e-5, plus an atol for elements near zero: 1e-6 on outputs of order 1;
on a gradient 1e-5 of its leaf's largest element (a small element is a
sum of large terms) plus 1e-8 of the largest gradient of any leaf (the
key biases' gradients are zero in exact arithmetic, since the softmax
ignores a constant per row, and are rounding noise of ~1e-12 on both
sides): the same fp32 operations summed in other orders.  Without
question text the text branch (``word_embed``, ``pos_embed``,
``ffn_t_*``) has zero gradients on both sides.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.models import projectors as jproj
from moka_tpu.models import qformer as jqf
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.models import projectors as tproj
from moka_tpu_torch.models import qformer as tqf
from moka_tpu_torch.train.optim import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-6)
QF = jqf.QFormerConfig(hidden=48, n_layers=2, n_heads=4, intermediate=96,
                       encoder_width=40, vocab_size=50, max_positions=16,
                       num_query_tokens=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def qformer():
    rng = np.random.default_rng(0)
    params = _np(jqf.init_qformer_params(jax.random.key(0), QF))
    states = rng.standard_normal((3, 7, QF.encoder_width)).astype(np.float32)
    enc_mask = np.ones((3, 7), np.int32)
    enc_mask[1, 5:] = 0
    text = rng.integers(0, QF.vocab_size, (3, 6)).astype(np.int32)
    text_mask = np.ones((3, 6), np.int32)
    text_mask[2, 4:] = 0
    return params, states, enc_mask, text, text_mask


@pytest.mark.parametrize("with_text", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_qformer_encode_matches_jax(qformer, with_text, with_mask):
    params, states, enc_mask, text, text_mask = qformer
    kw = {}
    if with_mask:
        kw["encoder_mask"] = enc_mask
    if with_text:
        kw.update(text_ids=text, text_mask=text_mask)
    want = jqf.qformer_encode(params, QF, jnp.asarray(states),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tqf.qformer_encode(
        params_from_numpy(params, "cpu"),
        tqf.QFormerConfig(**dataclasses.asdict(QF)), torch.from_numpy(states),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (3, QF.num_query_tokens, QF.hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _proj_cfg(kind):
    common = dict(num_query_tokens=4, qformer_hidden=48, qformer_heads=4,
                  qformer_intermediate=96, d_model=64)
    if kind == "visual":
        return jproj.ProjectorConfig(input_width=32, tokens_per_group=5,
                                     **common)
    return jproj.ProjectorConfig(input_width=40, tokens_per_group=-1,
                                 **common)


@pytest.mark.parametrize("with_question", [False, True])
@pytest.mark.parametrize("kind", ["visual", "audio"])
def test_projector_outputs_and_grads_match_jax(kind, with_question):
    """The output and the gradient of a fixed cotangent in every leaf,
    with and without a question broadcast to every group."""
    jcfg = _proj_cfg(kind)
    tcfg = tproj.ProjectorConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(1)
    params = _np(jproj.init_projector_params(jax.random.key(1), jcfg))
    b, t = 2, 3
    if kind == "visual":
        feats = rng.standard_normal((b, t * 5, 32)).astype(np.float32)
        jfn, tfn = jproj.project_visual, tproj.project_visual
    else:
        feats = rng.standard_normal((b, t, 6, 40)).astype(np.float32)
        jfn, tfn = jproj.project_audio, tproj.project_audio
    q = {}
    if with_question:
        q = dict(question_ids=rng.integers(0, 100, (b, 5)).astype(np.int32),
                 question_mask=np.array([[1] * 5, [1, 1, 1, 0, 0]],
                                        np.int32))
    cot = rng.standard_normal((b, t * 4, 64)).astype(np.float32)

    def jloss(p):
        out = jfn(p, jcfg, jnp.asarray(feats),
                  **{k: jnp.asarray(v) for k, v in q.items()})
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tparams = params_from_numpy(params, "cpu")
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    got = tfn(tparams, tcfg, torch.from_numpy(feats),
              **{k: torch.from_numpy(v) for k, v in q.items()})
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    assert got.shape == (b, t * 4, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    jleaves = jax.tree.leaves(jgrads)  # sorted keys, as tree_leaves
    assert len(jleaves) == len(grads)
    scale = max(np.abs(np.asarray(jg)).max() for jg in jleaves)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(
            g.numpy(), jg, rtol=1e-5,
            atol=1e-5 * np.abs(jg).max() + 1e-8 * scale)
    jtext = np.asarray(jgrads["qformer"]["word_embed"])
    assert (np.abs(jtext).max() > 0) == with_question
