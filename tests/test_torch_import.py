"""Port parity: checkpoint loading and the torch-checkpoint importers
(``train/import_torch.py``, ``ops/quant.py::import_llama_quantized``)
against the JAX package, on random HF-layout state dicts at tiny sizes.

Every comparison is exact: keys, dtypes, shapes and values of the port's
tree against the JAX tree carried over by ``convert.params_from_numpy``,
and ``load_torch``'s tensors against the JAX loader's arrays.  The HF
state dicts of CLIP, the projectors and the adapters come from the JAX
package's own exporters; LLaMA's and BEATs' are written key by key here.
"""

import json

import numpy as np
import jax
import pytest
import torch

from moka_tpu.core.config import LlamaConfig as JLlamaConfig
from moka_tpu.models.clip_vit import ClipVitConfig as JClipConfig
from moka_tpu.models.llava import LlavaConfig as JLlavaConfig
from moka_tpu.models.projectors import ProjectorConfig as JProjConfig
from moka_tpu.ops import quant as jquant
from moka_tpu.train import checkpoint as jckpt
from moka_tpu.train import import_torch as jimp
from moka_tpu_torch.convert import params_from_numpy
from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models.beats import BeatsConfig
from moka_tpu_torch.models.clip_vit import ClipVitConfig, init_clip_params
from moka_tpu_torch.models.llava import LlavaConfig
from moka_tpu_torch.models.projectors import (ProjectorConfig,
                                              init_projector_params)
from moka_tpu_torch.ops import quant as tquant
from moka_tpu_torch.train import import_torch as timp

JCFG, CFG = JLlamaConfig.tiny(vocab_size=96), LlamaConfig.tiny(vocab_size=96)
PROJ = dict(input_width=32, num_query_tokens=4, qformer_hidden=48,
            d_model=64, tokens_per_group=4)
HF_LLAMA = {"q": ("self_attn.q_proj", "q"), "k": ("self_attn.k_proj", "kv"),
            "v": ("self_attn.v_proj", "kv"), "o": ("self_attn.o_proj", "o"),
            "gate": ("mlp.gate_proj", "up"), "up": ("mlp.up_proj", "up"),
            "down": ("mlp.down_proj", "down")}


def assert_same(got, want_jax, path=""):
    """The port's tree equals the JAX tree carried over exactly."""
    want = params_from_numpy(jax.tree.map(np.asarray, want_jax), "cpu")
    _same(got, want, path)


def _same(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got) if isinstance(got, dict) else got,
             sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    assert torch.equal(got, want), path


def _np(tree):
    """A port tree as numpy fp32 (what the JAX exporters read)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.float().numpy()


def llama_sd(seed, tied=False):
    """A random HF LlamaForCausalLM state dict (fp32 torch tensors)."""
    g = torch.Generator().manual_seed(seed)
    d, hd = CFG.dim, CFG.head_dim
    outs = {"q": CFG.n_heads * hd, "kv": CFG.n_kv_heads * hd, "o": d,
            "up": CFG.intermediate, "down": d}
    ins = {"q": d, "kv": d, "o": CFG.n_heads * hd, "up": d,
           "down": CFG.intermediate}
    sd = {"model.embed_tokens.weight": torch.randn(CFG.vocab_size, d,
                                                   generator=g),
          "model.norm.weight": torch.randn(d, generator=g)}
    if not tied:
        sd["lm_head.weight"] = torch.randn(CFG.vocab_size, d, generator=g)
    for i in range(CFG.n_layers):
        p = f"model.layers.{i}."
        for hf, kind in HF_LLAMA.values():
            sd[f"{p}{hf}.weight"] = torch.randn(outs[kind], ins[kind],
                                                generator=g) * 0.05
        sd[f"{p}input_layernorm.weight"] = torch.randn(d, generator=g)
        sd[f"{p}post_attention_layernorm.weight"] = torch.randn(d,
                                                                generator=g)
    return sd


def _to_np(sd):
    return {k: v.float().numpy() for k, v in sd.items()}


def beats_sd(seed, full=True):
    """A random BEATs state dict with the weight-normed positional
    convolution; ``full=False`` leaves out the optional patch bias and
    the GRU gate (the importer's defaults)."""
    c = BeatsConfig.tiny()
    g = torch.Generator().manual_seed(seed)
    e, E, F_ = c.embed_dim, c.encoder_embed_dim, c.encoder_ffn_dim
    p, K = c.input_patch_size, c.conv_pos

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    sd = {"patch_embedding.weight": r(e, 1, p, p),
          "layer_norm.weight": r(e), "layer_norm.bias": r(e),
          "post_extract_proj.weight": r(E, e),
          "post_extract_proj.bias": r(E),
          "encoder.pos_conv.0.weight_g": r(1, 1, K).abs() + 0.5,
          "encoder.pos_conv.0.weight_v": r(E, E // c.conv_pos_groups, K),
          "encoder.pos_conv.0.bias": r(E),
          "encoder.layer_norm.weight": r(E),
          "encoder.layer_norm.bias": r(E),
          "encoder.layers.0.self_attn.relative_attention_bias.weight":
              r(c.num_buckets, c.encoder_heads)}
    if full:
        sd["patch_embedding.bias"] = r(e)
    for i in range(c.encoder_layers):
        q = f"encoder.layers.{i}."
        for name, shape in (("self_attn.q_proj", (E, E)),
                            ("self_attn.k_proj", (E, E)),
                            ("self_attn.v_proj", (E, E)),
                            ("self_attn.out_proj", (E, E)),
                            ("fc1", (F_, E)), ("fc2", (E, F_))):
            sd[f"{q}{name}.weight"] = r(*shape)
            sd[f"{q}{name}.bias"] = r(shape[0])
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{q}{name}.weight"] = r(E)
            sd[f"{q}{name}.bias"] = r(E)
        if full:
            sd[f"{q}self_attn.grep_linear.weight"] = r(8, c.head_dim)
            sd[f"{q}self_attn.grep_linear.bias"] = r(8)
            sd[f"{q}self_attn.grep_a"] = r(1, c.encoder_heads, 1, 1)
    cfg = {"input_patch_size": p, "embed_dim": e, "encoder_embed_dim": E,
           "encoder_layers": c.encoder_layers, "encoder_ffn_embed_dim": F_,
           "encoder_attention_heads": c.encoder_heads, "conv_bias": full,
           "deep_norm": True, "layer_norm_first": False,
           "relative_position_embedding": True,
           "num_buckets": c.num_buckets, "max_distance": c.max_distance,
           "gru_rel_pos": full, "conv_pos": K,
           "conv_pos_groups": c.conv_pos_groups}
    return sd, cfg


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_import_llama(tied, dtype):
    sd = llama_sd(0, tied)
    got = timp.import_llama(sd, CFG, getattr(torch, dtype), device="cpu")
    want = jimp.import_llama(_to_np(sd), JCFG, dtype=getattr(jax.numpy,
                                                             dtype))
    assert_same(got, want)


def test_import_llama_from_bf16_state_dict():
    """A bf16 checkpoint (as the port's loader keeps it) imports to the
    values the JAX importer gets from the same numbers widened to fp32."""
    sd = {k: v.bfloat16() for k, v in llama_sd(1).items()}
    got = timp.import_llama(sd, CFG, device="cpu")
    assert_same(got, jimp.import_llama(_to_np(sd), JCFG))


@pytest.mark.parametrize("bits,head_bits", [(4, 8), (8, None), (4, 4)])
def test_import_llama_quantized_codes(bits, head_bits):
    """Codes and scales bit-exact against the JAX import, and against the
    port's own quantize_llama_base(import_llama(sd))."""
    sd = llama_sd(2)
    got = tquant.import_llama_quantized(sd, CFG, bits=bits,
                                        head_bits=head_bits, device="cpu")
    assert_same(got, jquant.import_llama_quantized(
        _to_np(sd), JCFG, bits=bits, head_bits=head_bits))
    _same(got, tquant.quantize_llama_base(
        timp.import_llama(sd, CFG, device="cpu"), bits=bits,
        head_bits=head_bits), "")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_import_clip(dtype):
    ccfg = ClipVitConfig.tiny()
    tree = init_clip_params(torch.Generator().manual_seed(3), ccfg,
                            device="cpu")
    for prefix in ("vision_model.", ""):
        sd = jckpt.clip_to_torch_state_dict(_np(tree), ccfg, prefix=prefix)
        got = timp.import_clip({k: torch.from_numpy(v) for k, v in
                                sd.items()}, ccfg, getattr(torch, dtype),
                               device="cpu")
        want = jimp.import_clip(sd, JClipConfig.tiny(),
                                dtype=getattr(jax.numpy, dtype))
        assert_same(got, want)


@pytest.mark.parametrize("full", [True, False])
def test_import_beats_weight_norm(full):
    sd, cfg = beats_sd(4, full)
    tcfg = timp.beats_config_from_ckpt(cfg)
    jcfg = jimp.beats_config_from_ckpt(cfg)
    import dataclasses
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    got = timp.import_beats(sd, tcfg, torch.bfloat16, device="cpu")
    want = jimp.import_beats(_to_np(sd), jcfg, dtype=jax.numpy.bfloat16)
    assert_same(got, want)
    g = sd["encoder.pos_conv.0.weight_g"].numpy()
    v = sd["encoder.pos_conv.0.weight_v"].numpy()
    np.testing.assert_array_equal(timp.fold_weight_norm(g, v),
                                  jimp.fold_weight_norm(g, v))


@pytest.mark.parametrize("kind", ["visual", "audio"])
def test_import_qformer_projector(kind):
    pcfg = ProjectorConfig(**PROJ)
    tree = init_projector_params(torch.Generator().manual_seed(5), pcfg,
                                 device="cpu")
    sd = jckpt.projector_to_torch_state_dict(
        _np(tree), kind=kind, prefix="base_model.model.model.vl_projector.")
    sub_t = timp.strip_to_submodule(sd, "vl_projector.")
    sub_j = jimp.strip_to_submodule(sd, "vl_projector.")
    assert sub_t.keys() == sub_j.keys()
    got = timp.import_projector({k: torch.from_numpy(v) for k, v in
                                 sub_t.items()}, pcfg, kind=kind,
                                device="cpu")
    assert_same(got, jimp.import_projector(sub_j, JProjConfig(**PROJ),
                                           kind=kind))
    _same(got, tree, "")  # and the tree it was exported from
    q = {k[len(f"{kind}_Qformer."):]: torch.from_numpy(v)
         for k, v in sub_t.items() if k.startswith(f"{kind}_Qformer.")}
    assert_same(timp.import_qformer(q, pcfg.qformer()),
                jimp.import_qformer({k: v.numpy() for k, v in q.items()},
                                    JProjConfig(**PROJ).qformer()))


def _adapters(seed, m):
    from moka_tpu_torch.models.llama import _proj_shapes
    g = torch.Generator().manual_seed(seed)
    return {"layers": {
        name: {"a": torch.randn(CFG.n_layers, m, d_in, 4, generator=g),
               "b": torch.randn(CFG.n_layers, 4, d_out, generator=g)}
        for name, (d_in, d_out) in _proj_shapes(CFG).items()}}


def test_import_moka_adapters_avt():
    tree = _adapters(6, 3)
    sd = jckpt.adapters_to_torch_state_dict(_np(tree))
    got = timp.import_moka_adapters_avt(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG, 3, 4,
        device="cpu")
    assert_same(got, jimp.import_moka_adapters_avt(sd, JCFG, 3, 4))
    _same(got, tree, "")


def test_import_vt_trainable_and_adapters():
    lcfg = LlavaConfig.tiny()
    jcfg = JLlavaConfig.tiny()
    trainable = {"projector": init_projector_params(
                     torch.Generator().manual_seed(7), lcfg.projector,
                     device="cpu"),
                 "adapters": _adapters(8, 2)}
    sd = jckpt.export_vt_state_dict(_np(trainable), jcfg)
    zero = jax.tree.map(np.zeros_like, _np(trainable))
    got = timp.import_vt_trainable(
        {k: torch.from_numpy(v) for k, v in sd.items()}, lcfg,
        params_from_numpy(zero, "cpu"), device="cpu")
    assert_same(got, jimp.import_vt_trainable(sd, jcfg, zero))
    _same(got, trainable, "")
    assert_same(timp.import_moka_adapters_vt(sd, lcfg.llama, 4,
                                             device="cpu"),
                jimp.import_moka_adapters_vt(sd, jcfg.llama, 4))


# ------------------------------------------------------------ load_torch

def _loaded_same(got, want_np):
    """The port's loaded tensors (stored dtype) against the JAX loader's
    arrays (fp32 for .bin): the same numbers."""
    assert got.keys() == want_np.keys()
    for k in want_np:
        np.testing.assert_array_equal(got[k].float().numpy(), want_np[k],
                                      err_msg=k)


def test_load_torch_bin_and_safetensors(tmp_path):
    from safetensors.torch import save_file
    sd = llama_sd(9)
    bf = {k: v.bfloat16() for k, v in sd.items()}
    torch.save(bf, tmp_path / "ckpt.bin")
    got = timp.load_torch(str(tmp_path / "ckpt.bin"))
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    _loaded_same(got, jimp.load_torch(str(tmp_path / "ckpt.bin")))
    # torch's legacy (pre-zip) format, which cannot be memory-mapped
    torch.save(bf, tmp_path / "legacy.bin",
               _use_new_zipfile_serialization=False)
    _loaded_same(timp.load_torch(str(tmp_path / "legacy.bin")),
                 jimp.load_torch(str(tmp_path / "legacy.bin")))

    save_file(sd, str(tmp_path / "ckpt.safetensors"))
    _loaded_same(timp.load_torch(str(tmp_path / "ckpt.safetensors")),
                 jimp.load_torch(str(tmp_path / "ckpt.safetensors")))
    # bf16 safetensors: the JAX loader cannot hold bf16; the port keeps it
    save_file(bf, str(tmp_path / "bf16.safetensors"))
    got = timp.load_torch(str(tmp_path / "bf16.safetensors"))
    for k in bf:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], bf[k])


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_torch_shard_directory(tmp_path, fmt):
    """Two shards plus an index file, merged; the whole chain to the
    imported tree equals JAX's."""
    from safetensors.torch import save_file
    sd = llama_sd(10)
    keys = sorted(sd)
    halves = [dict((k, sd[k]) for k in keys[:len(keys) // 2]),
              dict((k, sd[k]) for k in keys[len(keys) // 2:])]
    for i, part in enumerate(halves, 1):
        if fmt == "safetensors":
            save_file(part, str(tmp_path / f"model-0000{i}-of-00002"
                                            f".safetensors"))
        else:
            torch.save(part, tmp_path / f"pytorch_model-0000{i}-of-00002.bin")
    (tmp_path / f"model.{fmt}.index.json").write_text(json.dumps(
        {"weight_map": {k: "shard" for k in keys}}))
    got = timp.load_torch(str(tmp_path))
    want = jimp.load_torch(str(tmp_path))
    _loaded_same(got, want)
    assert_same(timp.import_llama(got, CFG, device="cpu"),
                jimp.import_llama(want, JCFG))


def test_load_torch_beats_checkpoint(tmp_path):
    sd, cfg = beats_sd(11)
    torch.save({"cfg": cfg, "model": {k: v.bfloat16() for k, v in
                                      sd.items()}}, tmp_path / "beats.pt")
    got_sd, got_cfg = timp.load_torch(str(tmp_path / "beats.pt"))
    assert got_cfg == cfg
    assert all(v.dtype == torch.bfloat16 for v in got_sd.values())
    # the JAX loader cannot turn bf16 tensors into numpy: feed it fp32
    torch.save({"cfg": cfg, "model": sd}, tmp_path / "beats32.pt")
    want_sd, want_cfg = jimp.load_torch(str(tmp_path / "beats32.pt"))
    assert want_cfg == cfg
    _loaded_same({k: v.float() for k, v in got_sd.items()},
                 {k: np.asarray(v, np.float32).astype(
                     jax.numpy.bfloat16).astype(np.float32)
                  for k, v in want_sd.items()})
    assert_same(timp.import_beats(got_sd, timp.beats_config_from_ckpt(
                    got_cfg), torch.bfloat16, device="cpu"),
                jimp.import_beats(
                    {k: v.float().numpy() for k, v in got_sd.items()},
                    jimp.beats_config_from_ckpt(want_cfg),
                    dtype=jax.numpy.bfloat16))


def test_importers_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timp.import_llama(llama_sd(12), CFG)
