"""Port parity: checkpoints and the torch-format exports
(``train/checkpoint.py``) against the JAX package.

- A JAX ``TrainState`` after three steps (MokA AVT, dropout 0.05,
  gradient accumulation over 2 micro-steps, so the MultiSteps fields are
  mid-accumulation) is carried over by ``convert.train_state_from_numpy``,
  saved and restored by the port; two more steps from the restored state
  equal two more from the live one (losses to 1e-6 relative, as the JAX
  package's own resume test; the parameters and optimizer state come out
  bitwise equal).
- ``latest_step``, ``max_to_keep``, a step saved twice, and a half-written
  step directory.
- Every export against JAX's on the same tree: keys, shapes, dtypes and
  values exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JCfg, TrainConfig as JTrain
from moka_tpu.models import llama as jllama
from moka_tpu.models.llava import LlavaConfig as JLlavaConfig
from moka_tpu.ops.moka import MokaSpec as JSpec
from moka_tpu.train import checkpoint as jckpt
from moka_tpu.train import optim as joptim
from moka_tpu.train.objectives import make_llama_moka_loss as j_make_loss
from moka_tpu.train.step import init_train_state as j_init
from moka_tpu.train.step import make_train_step as j_make_step
from moka_tpu_torch.convert import params_from_numpy, train_state_from_numpy
from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.models import llama as tllama
from moka_tpu_torch.models.clip_vit import init_clip_params
from moka_tpu_torch.models.llava import LlavaConfig
from moka_tpu_torch.models.projectors import init_projector_params
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.ops.quant import quantize_llama_base
from moka_tpu_torch.train import checkpoint as tckpt
from moka_tpu_torch.train import optim as toptim
from moka_tpu_torch.train.objectives import make_llama_moka_loss
from moka_tpu_torch.train.step import TrainState, init_train_state, \
    make_train_step

JCFG, CFG = JCfg.tiny(vocab_size=64), LlamaConfig.tiny(vocab_size=64)
JSPEC = JSpec.avt(rank=4, dropout_rate=0.05)
SPEC = MokaSpec.avt(rank=4, dropout_rate=0.05)
TRAIN = dict(learning_rate=1e-3, warmup_ratio=0.0, grad_accum=2)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _tnp(tree):
    """A port tree as numpy: floats widened to fp32, integers kept."""
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return (tree.float() if tree.is_floating_point() else tree).numpy()


@pytest.fixture(scope="module")
def world():
    r1, r2 = jax.random.split(jax.random.key(0))
    base = jllama.init_llama_params(r1, JCFG, dtype=jnp.float32)
    trainable = {"adapters": jllama.init_moka_adapters(r2, JCFG, JSPEC)}
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 64, (2, 16)).astype(np.int32)
    mod = np.zeros((3, 2, 16), np.float32)
    mod[0, :, :8], mod[1, :, 8:12], mod[2, :, 12:] = 1, 1, 1
    q = np.zeros((2, 16), np.float32)
    q[:, 2:5] = 1
    batch = dict(tokens=toks, labels=toks, modality_masks=mod,
                 question_mask=q)
    tx = joptim.make_optimizer(JTrain(**TRAIN), total_steps=20)
    step = j_make_step(j_make_loss(JCFG, JSPEC, remat=False), tx,
                       donate=False)
    state = j_init(trainable, tx, jax.random.key(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        state, _ = step(state, base, jb)
    return _np(base), _np(dataclasses.replace(state, rng=None)), batch


def _leaves_equal(a, b):
    la, lb = toptim.tree_leaves(a), toptim.tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


def test_resume_from_a_jax_state_matches_live(world, tmp_path):
    base, jstate, batch = world
    frozen = params_from_numpy(base, "cpu")
    tb = params_from_numpy(batch, "cpu")
    tx = toptim.make_optimizer(TrainConfig(**TRAIN), total_steps=20)
    step = make_train_step(make_llama_moka_loss(CFG, SPEC, remat=False), tx)
    live = train_state_from_numpy(jstate, "cpu", DropoutKey(5))
    assert live.step == 3 and live.opt_state.mini_step == 1
    assert live.opt_state.gradient_step == 1
    tckpt.save(str(tmp_path / "run"), live)
    assert tckpt.latest_step(str(tmp_path / "run")) == 3

    template = init_train_state(
        {"adapters": tllama.init_moka_adapters(
            torch.Generator().manual_seed(9), CFG, SPEC, device="cpu")},
        tx, DropoutKey(0))
    restored = tckpt.restore(str(tmp_path / "run"), template)
    assert restored.step == 3 and restored.rng.seed == live.rng.seed
    for f in ("count", "mini_step", "gradient_step"):
        assert getattr(restored.opt_state, f) == getattr(live.opt_state, f)
    for f in ("mu", "nu", "acc_grads"):
        assert _leaves_equal(getattr(restored.opt_state, f),
                             getattr(live.opt_state, f))
    assert _leaves_equal(restored.params, live.params)

    for _ in range(2):
        live, m_live = step(live, frozen, tb)
    for _ in range(2):
        restored, m_res = step(restored, frozen, tb)
    np.testing.assert_allclose(float(m_res["loss"]), float(m_live["loss"]),
                               rtol=1e-6)
    assert _leaves_equal(restored.params, live.params)
    assert _leaves_equal(restored.opt_state.mu, live.opt_state.mu)


def _tiny_state(step, value):
    params = {"adapters": {"a": torch.full((2, 3), float(value))}}
    opt = toptim.OptState(count=step, mu=toptim.tree_map(torch.zeros_like,
                                                         params),
                          nu=toptim.tree_map(torch.ones_like, params))
    return TrainState(step=step, params=params, opt_state=opt,
                      rng=DropoutKey(step))


def test_latest_step_max_to_keep_and_partial_writes(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, _tiny_state(0, 0))
    for s in range(1, 6):
        tckpt.save(d, _tiny_state(s, s))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["3", "4", "5"]
    assert tckpt.latest_step(d) == 5
    # saving a step that exists (the last periodic save, then finalize)
    tckpt.save(d, _tiny_state(5, 50))
    got = tckpt.restore(d, _tiny_state(0, 0))
    assert got.step == 5 and float(got.params["adapters"]["a"][0, 0]) == 50
    assert got.rng.seed == 5 and got.opt_state.count == 5
    # a half-written step (its temporary directory, or a step directory
    # without the state file) is never the latest
    (tmp_path / "ck" / ".tmp-7-x").mkdir()
    (tmp_path / "ck" / ".tmp-7-x" / "state.pt").write_bytes(b"partial")
    (tmp_path / "ck" / "8").mkdir()
    assert tckpt.latest_step(d) == 5
    assert tckpt.restore(d, _tiny_state(0, 0), step=4).step == 4


# ------------------------------------------------------------ exports

def _sd_same(got: dict, want: dict):
    """A port export (CPU tensors) against JAX's (numpy): keys, shapes,
    dtypes and values exact."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:5]
    for k, w in want.items():
        g = got[k]
        w = np.asarray(w) if not torch.is_tensor(w) else w.numpy()
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def _adapters(seed, m):
    from moka_tpu_torch.models.llama import _proj_shapes
    g = torch.Generator().manual_seed(seed)
    return {"layers": {
        name: {"a": torch.randn(CFG.n_layers, m, d_in, 4, generator=g),
               "b": torch.randn(CFG.n_layers, 4, d_out, generator=g)}
        for name, (d_in, d_out) in _proj_shapes(CFG).items()}}


@pytest.fixture(scope="module")
def vt_trees():
    lcfg = LlavaConfig.tiny()
    g = torch.Generator().manual_seed(3)
    clip = init_clip_params(g, lcfg.clip, device="cpu")
    for k in ("cls", "patch", "pos"):  # as import_clip(dtype=bf16) gives
        clip[k] = clip[k].bfloat16()
    base = tllama.init_llama_params(g, lcfg.llama, device="cpu")
    trainable = {"projector": init_projector_params(g, lcfg.projector,
                                                    device="cpu"),
                 "adapters": _adapters(4, 2)}
    return lcfg, clip, base, trainable


def test_adapter_and_projector_exports(vt_trees):
    lcfg, _, _, trainable = vt_trees
    ad = _adapters(5, 3)
    _sd_same(tckpt.adapters_to_torch_state_dict(ad),
             jckpt.adapters_to_torch_state_dict(_tnp(ad)))
    _sd_same(tckpt.adapters_to_torch_state_dict(ad, prefix="x."),
             jckpt.adapters_to_torch_state_dict(_tnp(ad), prefix="x."))
    for kind in ("visual", "audio"):
        _sd_same(tckpt.projector_to_torch_state_dict(
                     trainable["projector"], kind=kind, prefix="p."),
                 jckpt.projector_to_torch_state_dict(
                     _tnp(trainable["projector"]), kind=kind, prefix="p."))


@pytest.mark.parametrize("stage1", [False, True])
def test_export_torch_artifacts(vt_trees, tmp_path, stage1):
    _, _, _, trainable = vt_trees
    tree = {"adapters": _adapters(6, 3),
            "vl_projector": trainable["projector"],
            "al_projector": trainable["projector"],
            "new_token_embeds": torch.randn(
                11, 64, generator=torch.Generator().manual_seed(7))}
    tckpt.export_torch_artifacts(str(tmp_path / "t"), tree, stage1=stage1)
    jckpt.export_torch_artifacts(str(tmp_path / "j"), _tnp(tree),
                                 stage1=stage1)
    for name in ("adapter_model.bin", "non_lora_trainables.bin"):
        got = torch.load(tmp_path / "t" / name, weights_only=True)
        want = torch.load(tmp_path / "j" / name, weights_only=True)
        _sd_same(got, {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("quantized", [False, True])
def test_vt_exports(vt_trees, tmp_path, quantized):
    from safetensors.numpy import load_file
    lcfg, clip, base, trainable = vt_trees
    jcfg = JLlavaConfig.tiny()
    if quantized:
        base = quantize_llama_base(base, bits=4, head_bits=8)
    frozen = {"clip": clip, "llama": base}
    _sd_same(tckpt.clip_to_torch_state_dict(clip, lcfg.clip),
             jckpt.clip_to_torch_state_dict(_tnp(clip), jcfg.clip))
    want_vt = jckpt.export_vt_state_dict(_tnp(trainable), jcfg)
    _sd_same(tckpt.export_vt_state_dict(trainable, lcfg), want_vt)
    want_full = jckpt.export_vt_full_state_dict(_tnp(trainable),
                                                _tnp(frozen), jcfg)
    _sd_same(tckpt.export_vt_full_state_dict(trainable, frozen, lcfg),
             want_full)
    tckpt.save_vt_safetensors(str(tmp_path / "vt.safetensors"), trainable,
                              lcfg)
    tckpt.save_vt_full_safetensors(str(tmp_path / "full.safetensors"),
                                   trainable, frozen, lcfg)
    for path, want in (("vt.safetensors", want_vt),
                       ("full.safetensors", want_full)):
        got = load_file(str(tmp_path / path))
        _sd_same({k: torch.from_numpy(v) for k, v in got.items()}, want)
