"""Port parity: the multimodal assembler (``data/assembler.py``) against
the JAX package on the CPU: ``assemble_sample`` and ``pad_batch``
array-equal on the layouts ``bench.py::run_multimodal`` (training) and
``bench_decode.py::_mm_eval_batch`` (eval prompts) build, the question
window's overflow rule, and ``splice_features`` with its gradient (exact:
a scatter moves values without arithmetic)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.data import assembler as jasm
from moka_tpu_torch.data import assembler as tasm

VOCAB = 300
BASE = VOCAB - len(jasm.SPECIAL_TOKENS)
T2I = {t: BASE + i for i, t in enumerate(jasm.SPECIAL_TOKENS)}


def _sample(rng, i, n_prefix, n_question, n_answer):
    """bench.py's layout: prefix, <video>, <audio>, the question between
    its markers, then the answer (the only supervised tokens)."""
    prefix = rng.integers(4, BASE, n_prefix + i).tolist()
    q_toks = rng.integers(4, BASE, n_question).tolist()
    answer = rng.integers(4, BASE, n_answer).tolist()
    ids = (prefix
           + [T2I["<video_start>"], T2I["<video>"], T2I["<video_end>"]]
           + [T2I["<audio_start>"], T2I["<audio>"], T2I["<audio_end>"]]
           + [T2I["<question_start>"]] + q_toks + [T2I["<question_end>"]]
           + answer)
    labels = [-100] * (len(ids) - len(answer)) + answer
    return np.asarray(ids, np.int32), np.asarray(labels, np.int32)


def _same(want, got):
    assert set(vars(want) if not isinstance(want, dict) else want) == \
        set(vars(got) if not isinstance(got, dict) else got)
    items = want.items() if isinstance(want, dict) else vars(want).items()
    for k, w in items:
        g = got[k] if isinstance(got, dict) else getattr(got, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("layout", ["train", "eval"])
def test_assemble_and_pad_match_jax(layout):
    assert tasm.SPECIAL_TOKENS == jasm.SPECIAL_TOKENS
    assert tasm.MARKER_KEYS == jasm.MARKER_KEYS
    rng = np.random.default_rng(0)
    nv, na = 3 * 4, 2 * 4
    samples = []
    for i in range(3):
        if layout == "train":
            samples.append(_sample(rng, i, 16, 16, 20 - 3 * i))
        else:
            samples.append(_sample(rng, i, 16, 24, 0))
    jout, tout = [], []
    for ids, labels in samples:
        kw = dict(n_video_tokens=nv, n_audio_tokens=na,
                  max_question_tokens=32)
        jout.append(jasm.assemble_sample(ids, labels, T2I, 0, **kw))
        tout.append(tasm.assemble_sample(ids, labels, T2I, 0, **kw))
        _same(jout[-1], tout[-1])
    pad_to = 128 if layout == "train" else None
    _same(jasm.pad_batch(jout, 0, pad_to=pad_to),
          tasm.pad_batch(tout, 0, pad_to=pad_to))
    _same(jasm.pad_batch(jout, 0, left_pad=False),
          tasm.pad_batch(tout, 0, left_pad=False))


def test_question_window_overflow_matches_jax():
    ids, labels = _sample(np.random.default_rng(1), 0, 8, 20, 4)
    for mod in (jasm, tasm):
        with pytest.raises(mod.QuestionWindowOverflow):
            mod.assemble_sample(ids, labels, T2I, 0, n_video_tokens=4,
                                n_audio_tokens=4, max_question_tokens=16)
    kw = dict(n_video_tokens=4, n_audio_tokens=4, max_question_tokens=16,
              question_overflow="disable")
    want = jasm.assemble_sample(ids, labels, T2I, 0, **kw)
    got = tasm.assemble_sample(ids, labels, T2I, 0, **kw)
    _same(want, got)
    assert not got.question_mask.any()
    assert issubclass(tasm.QuestionWindowOverflow, ValueError)
    with pytest.raises(ValueError, match="pad_to"):
        tasm.pad_batch([got], 0, pad_to=4)


def test_splice_features_and_its_gradient_match_jax():
    """Forward equal to JAX's scatter; the gradient of a fixed cotangent
    reaches the features at their positions and the embeddings elsewhere,
    exactly as JAX's; the input embeddings are not written in place."""
    rng = np.random.default_rng(2)
    b, L, d = 2, 10, 6
    embeds = rng.standard_normal((b, L, d)).astype(np.float32)
    vf = rng.standard_normal((b, 3, d)).astype(np.float32)
    af = rng.standard_normal((b, 2, d)).astype(np.float32)
    vpos = np.array([[2, 3, 4], [4, 5, 6]], np.int32)
    apos = np.array([[6, 7], [8, 9]], np.int32)
    cot = rng.standard_normal((b, L, d)).astype(np.float32)

    def jfn(e, v, a):
        out = jasm.splice_features(e, video_features=v, video_pos=vpos,
                                   audio_features=a, audio_pos=apos)
        return jnp.sum(out * cot), out

    (_, want), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(embeds), jnp.asarray(vf), jnp.asarray(af))
    te, tv, ta = (torch.from_numpy(x.copy()).requires_grad_(True)
                  for x in (embeds, vf, af))
    got = tasm.splice_features(te, video_features=tv,
                               video_pos=torch.from_numpy(vpos),
                               audio_features=ta,
                               audio_pos=torch.from_numpy(apos))
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                (te, tv, ta))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for g, w in zip(grads, jg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(te.detach().numpy(), embeds)
    none = torch.zeros((b, 0), dtype=torch.int32)
    empty = tasm.splice_features(te, video_features=tv, video_pos=none)
    assert torch.equal(empty, te)
