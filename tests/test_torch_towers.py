"""Port parity: the frozen towers (``models/clip_vit.py``,
``models/beats.py``), ``quant.quantize_encoder`` and the towers' dense
products, against the JAX package on the CPU, same numpy weights and
inputs.

Tolerances: the towers in fp32 to rtol 1e-5 (+ atol 1e-5 for elements
near zero): the same fp32 operations, summed in other orders.  JAX's flash
path runs its Pallas kernel in interpret mode, the port's the plain flash
forward (the kernel's arithmetic on the CPU).  BEATs' bucket ids, the
codes and scales of ``quantize_encoder`` and the W8A8 dense product
(``qmatmul_a8``: an exact int32 product, then ``(acc * sx) * sw`` in fp32)
bit-exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.models import beats as jbeats
from moka_tpu.models import clip_vit as jclip
from moka_tpu.ops import quant as jq
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.models import beats as tbeats
from moka_tpu_torch.models import clip_vit as tclip
from moka_tpu_torch.models.layers import dense
from moka_tpu_torch.ops import quant as tq

TOL = dict(rtol=1e-5, atol=1e-5)
CLIP_HD64 = jclip.ClipVitConfig(image_size=28, patch_size=14, hidden=128,
                                n_layers=2, n_heads=2, intermediate=256)
BEATS_HD64 = jbeats.BeatsConfig(embed_dim=96, encoder_embed_dim=128,
                                encoder_layers=2, encoder_ffn_dim=256,
                                encoder_heads=2, num_buckets=16,
                                max_distance=64, conv_pos=16,
                                conv_pos_groups=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _images(cfg, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, cfg.image_size, cfg.image_size)).astype(np.float32)


@pytest.fixture(scope="module")
def clip_tiny():
    cfg = jclip.ClipVitConfig.tiny()
    return cfg, _np(jclip.init_clip_params(jax.random.key(0), cfg)), \
        _images(cfg)


def test_patchify_bit_exact():
    imgs = _images(jclip.ClipVitConfig(), n=2)
    want = np.asarray(jclip.patchify(jnp.asarray(imgs), 14))
    got = tclip.patchify(torch.from_numpy(imgs), 14).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
def test_clip_hidden_states_match_jax(clip_tiny, use_flash):
    """Every selected layer (0 = the embedding, 1, 2), eager and flash."""
    jcfg, params, imgs = clip_tiny
    jcfg = dataclasses.replace(jcfg, use_flash=use_flash)
    want = jclip.clip_hidden_states(params, jcfg, jnp.asarray(imgs),
                                    (0, 1, 2))
    got = tclip.clip_hidden_states(
        params_from_numpy(params, "cpu"),
        _torch_cfg(tclip.ClipVitConfig, jcfg), torch.from_numpy(imgs),
        (0, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_clip_head_dim_64_flash_matches_jax_interpret():
    """Head_dim 64, the card kernel's CLIP width: JAX's flash kernel in
    interpret mode against the port's flash path, and both against the
    eager tower; ``encode_video`` regroups frames per sample."""
    jcfg = dataclasses.replace(CLIP_HD64, use_flash=True)
    params = _np(jclip.init_clip_params(jax.random.key(1), jcfg))
    video = np.random.default_rng(1).standard_normal(
        (2, 2, 3, 28, 28)).astype(np.float32)
    want = jclip.encode_video(params, jcfg, jnp.asarray(video), (1, 2))
    tparams = params_from_numpy(params, "cpu")
    tcfg = _torch_cfg(tclip.ClipVitConfig, jcfg)
    got = tclip.encode_video(tparams, tcfg, torch.from_numpy(video), (1, 2))
    eager = tclip.encode_video(tparams, dataclasses.replace(
        tcfg, use_flash=False), torch.from_numpy(video), (1, 2))
    for g, e, w in zip(got, eager, want):
        assert g.shape == (2, 2 * jcfg.n_patches, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(e.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("length", [96, 1400])
def test_beats_bucket_ids_exact(length):
    """Every relative distance of L 96 (the step's 12 x 8 patches) and of
    L 1400 (past max_distance 1280) at the AS2M config's 320 buckets."""
    cfg = jbeats.BeatsConfig()
    pos = np.arange(length)
    rel = (pos[None, :] - pos[:, None]).astype(np.int32)
    want = np.asarray(jbeats._t5_bucket_bidirectional(
        jnp.asarray(rel), cfg.num_buckets, cfg.max_distance))
    got = tbeats._t5_bucket_bidirectional(
        torch.from_numpy(rel), cfg.num_buckets, cfg.max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == cfg.num_buckets - 1 or length < 1280


def _fbank(n=3, frames=64, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, frames, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def beats_tiny():
    cfg = jbeats.BeatsConfig.tiny()
    return cfg, _np(jbeats.init_beats_params(jax.random.key(3), cfg))


@pytest.mark.parametrize("padded", [False, True])
def test_beats_encode_matches_jax(beats_tiny, padded):
    jcfg, params = beats_tiny
    fbank = _fbank()
    mask = None
    if padded:  # 32 tokens a segment; pad the last 5 and 12 of two rows
        mask = np.zeros((3, 32), np.int32)
        mask[1, -5:] = 1
        mask[2, -12:] = 1
    want = jbeats.beats_encode(params, jcfg, jnp.asarray(fbank),
                               None if mask is None else jnp.asarray(mask))
    got = tbeats.beats_encode(
        params_from_numpy(params, "cpu"),
        _torch_cfg(tbeats.BeatsConfig, jcfg), torch.from_numpy(fbank),
        None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, 32, jcfg.encoder_embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_audio_segments_matches_jax(beats_tiny):
    jcfg, params = beats_tiny
    audio = _fbank(n=4).reshape(2, 2, 64, 128)
    want = jbeats.encode_audio_segments(params, jcfg, jnp.asarray(audio))
    got = tbeats.encode_audio_segments(
        params_from_numpy(params, "cpu"),
        _torch_cfg(tbeats.BeatsConfig, jcfg), torch.from_numpy(audio))
    assert got.shape == (2, 2, 32, jcfg.encoder_embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _leaf_paths(tree, prefix=()):
    """{path: kind} of a tree: a quantized dict as one leaf."""
    if isinstance(tree, dict) and not ("w_i8" in tree or "w_i4" in tree):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, dict):
        return {prefix: "w_i8" if "w_i8" in tree else "w_i4"}
    return {prefix: "none" if tree is None else "array"}


def _tower(name):
    if name == "clip":
        return _np(jclip.init_clip_params(jax.random.key(4), CLIP_HD64))
    return _np(jbeats.init_beats_params(jax.random.key(5), BEATS_HD64))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tower", ["clip", "beats"])
def test_quantize_encoder_matches_jax(tower, bits):
    """The same leaves quantized (``min_dim`` 64: BEATs' (64, 8) gate,
    norms, embeddings and the conv kernel stay), codes and scales
    bit-exact."""
    params = _tower(tower)
    want = _np(jq.quantize_encoder(jax.tree.map(jnp.asarray, params),
                                   bits=bits))
    got = tq.quantize_encoder(params_from_numpy(params, "cpu"), bits=bits)
    paths = _leaf_paths(want)
    assert _leaf_paths(got) == paths
    quantized = {p for p, kind in paths.items() if kind.startswith("w_")}
    assert quantized and all(p[-1] == "w" for p in quantized)
    assert ("layers", "grep", "w") not in quantized

    def walk(j, t):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                walk(j[k], t[k])
        elif j is None:
            assert t is None
        else:
            assert t.dtype == params_from_numpy(j, "cpu").dtype
            np.testing.assert_array_equal(t.numpy(), j)

    walk(want, got)


@pytest.mark.parametrize("a8", [False, True])
def test_tower_dense_on_an_int8_weight_matches_jax(a8):
    """The towers' ``_dense`` on an int8 leaf: W8A8 (a8, 3-D x) or
    weight-only, bit-exact; a 4-D x takes the weight-only product."""
    params = _np(jq.quantize_encoder(jax.tree.map(
        jnp.asarray, _tower("clip")), bits=8))
    p = jax.tree.map(lambda a: a[0], params["layers"]["fc1"])
    x = np.random.default_rng(6).standard_normal((2, 5, 128)).astype(
        np.float32)
    x[0, 1] = 0  # an all-zero token: scale 1, codes 0
    tp = params_from_numpy(p, "cpu")
    for xs in (x, x.reshape(2, 5, 1, 128)):
        want = np.asarray(jclip._dense(jnp.asarray(xs), p, a8=a8))
        got = dense(torch.from_numpy(xs), tp, a8=a8).numpy()
        np.testing.assert_array_equal(got, want)


def test_quantized_towers_match_jax():
    """int8 towers, weight-only and with a8 dots, end to end: weight-only
    to TOL; a8 within 1e-3 of the largest feature (a per-token code can
    round the other way after fp32 sums in another order, 1/127 of that
    token's largest activation)."""
    clip = _np(jq.quantize_encoder(jax.tree.map(
        jnp.asarray, _tower("clip")), bits=8))
    beats = _np(jq.quantize_encoder(jax.tree.map(
        jnp.asarray, _tower("beats")), bits=8))
    imgs, fbank = _images(CLIP_HD64, n=2), _fbank(n=2)
    for a8 in (False, True):
        jc = dataclasses.replace(CLIP_HD64, a8_dots=a8)
        jb = dataclasses.replace(BEATS_HD64, a8_dots=a8)
        outs = [
            (jclip.clip_hidden_states(clip, jc, jnp.asarray(imgs), (2,))[0],
             tclip.clip_hidden_states(
                 params_from_numpy(clip, "cpu"),
                 _torch_cfg(tclip.ClipVitConfig, jc),
                 torch.from_numpy(imgs), (2,))[0]),
            (jbeats.beats_encode(beats, jb, jnp.asarray(fbank)),
             tbeats.beats_encode(params_from_numpy(beats, "cpu"),
                                 _torch_cfg(tbeats.BeatsConfig, jb),
                                 torch.from_numpy(fbank)))]
        for want, got in outs:
            want = np.asarray(want)
            if a8:
                err = np.abs(got.numpy() - want).max()
                assert err <= 1e-3 * np.abs(want).max(), err
            else:
                np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_kernel_takes_head_dim_64_forward_only():
    """The kernels' input check: the forward takes head_dim 64 (the CLIP
    tower) and 128; the backward kernels 128 only; other widths raise."""
    from moka_tpu_torch.ops import flash_attention as fa

    def tensors(hd):
        q = torch.zeros((2, 257, 16, hd), dtype=torch.bfloat16)
        return q, q.clone(), q.clone(), torch.ones((2, 257))

    q, k, v, mask = tensors(64)
    out = fa._kernel_inputs(q, k, v, mask, head_dims=fa.FWD_HEAD_DIMS)
    assert out[3].dtype == torch.int32 and out[0].shape == q.shape
    with pytest.raises(ValueError, match="head_dim"):
        fa._kernel_inputs(q, k, v, mask)
    for heads in (fa.FWD_HEAD_DIMS, fa.BWD_HEAD_DIMS):
        with pytest.raises(ValueError, match="head_dim"):
            fa._kernel_inputs(*tensors(32), head_dims=heads)
