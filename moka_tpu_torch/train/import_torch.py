"""Torch-checkpoint importers: reference artifacts -> the port's trees
(port of ``moka_tpu/train/import_torch.py``).

Every artifact family the reference produces or consumes:
  * HF LLaMA base weights               -> llama params (layer-stacked)
  * HF CLIPVisionModel                  -> clip_vit params
  * BEATs ``.pt`` (cfg + model)         -> beats params (weight-norm folded)
  * Q-Former/projector state dicts      -> projector params
  * ``adapter_model.bin`` (peft MokA)   -> adapter params
  * ``non_lora_trainables.bin`` / ``visual_pretrain.bin`` -> projector

The importers take ``{name: tensor}`` dicts (numpy arrays are accepted
too); ``load_torch`` reads ``.bin``/``.pt``/``.safetensors`` on the CPU
and keeps each tensor's stored dtype (bf16 included).  Torch linear
weights are (out, in) and are transposed into the (in, out) layout.  The
trees have the keys, layouts and dtypes of the JAX importers' trees as
``convert.params_from_numpy`` carries them over: what the JAX importer
widens to fp32 is fp32 here, what it casts to ``dtype`` is ``dtype``.

``import_llama`` fills one preallocated tensor a projection family on the
target device, layer by layer, casting on the way: the host never holds
more than the checkpoint itself (the JAX importer widens every tensor to
fp32 and stacks all layers at once on the host).
"""

from __future__ import annotations

import os
import re
import zipfile

import numpy as np
import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.models.beats import BeatsConfig
from moka_tpu_torch.models.clip_vit import ClipVitConfig
from moka_tpu_torch.models.llama import _proj_shapes
from moka_tpu_torch.models.qformer import QFormerConfig

LLAMA_KEYS = {  # tree key -> HF LlamaForCausalLM name within layer i
    "q": "self_attn.q_proj.weight", "k": "self_attn.k_proj.weight",
    "v": "self_attn.v_proj.weight", "o": "self_attn.o_proj.weight",
    "gate": "mlp.gate_proj.weight", "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
    "attn_norm": "input_layernorm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
}


def load_torch(path: str):
    """A torch or safetensors checkpoint on the CPU: ``{name: tensor}``,
    or ``(model dict, cfg)`` for a BEATs-style ``{cfg, model}`` file.

    Accepts a single file or a directory of shards
    (``model-0000x-of-0000y.safetensors`` / ``pytorch_model*.bin``),
    merged.  ``.safetensors`` reads through ``safetensors.torch`` (bf16
    kept, memory-mapped); ``.bin``/``.pt`` through ``torch.load``."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        shards = [n for n in names if n.endswith(".safetensors")
                  and not n.endswith(".index.json")]
        if not shards:
            shards = [n for n in names
                      if n.startswith("pytorch_model") and n.endswith(".bin")]
        if not shards:
            raise FileNotFoundError(f"no checkpoint shards under {path}")
        merged: dict = {}
        for n in shards:
            merged.update(load_torch(os.path.join(path, n)))
        return merged
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    # memory-mapped where the file is torch's zip format (the legacy
    # format cannot be mapped)
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict) and "model" in obj and \
            isinstance(obj["model"], dict):
        return dict(obj["model"]), obj.get("cfg")  # BEATs-style {cfg, model}
    return dict(obj)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _f32(x) -> torch.Tensor:
    return _tensor(x).float()


def _t(w) -> torch.Tensor:
    return _f32(w).t().contiguous()


def _lin(sd, prefix) -> dict:
    w = _t(sd[prefix + ".weight"])
    b = _f32(sd[prefix + ".bias"]) if prefix + ".bias" in sd else \
        torch.zeros(w.shape[1])
    return {"w": w, "b": b}


def _lnp(sd, prefix) -> dict:
    return {"g": _f32(sd[prefix + ".weight"]), "b": _f32(sd[prefix + ".bias"])}


def _stack(items: list[dict]) -> dict:
    """A list of per-layer trees -> one tree of layer-stacked tensors."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


# ---------------------------------------------------------------- LLaMA ----

def llama_weight(sd: dict, name: str, layer: int, device) -> torch.Tensor:
    """Layer ``layer``'s ``name`` weight on ``device`` in the tree's layout
    ((d_in, d_out) for a projection, (dim,) for a norm), stored dtype: the
    checkpoint's (out, in) tensor is moved as it is stored and transposed
    there (a view)."""
    w = _tensor(sd[f"model.layers.{layer}.{LLAMA_KEYS[name]}"]).to(device)
    return w.t() if w.dim() == 2 else w


def llama_whole(sd: dict, name: str, dtype, device) -> torch.Tensor:
    """``embed``, ``final_norm`` or ``lm_head`` (tied to the embedding when
    the checkpoint has none) in the tree's layout, in ``dtype``."""
    if name == "lm_head":
        w = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
        return _tensor(w).to(device).t().to(dtype).contiguous()
    hf = {"embed": "model.embed_tokens.weight",
          "final_norm": "model.norm.weight"}[name]
    return _tensor(sd[hf]).to(device).to(dtype).contiguous()


def import_llama(sd: dict, cfg: LlamaConfig, dtype=torch.bfloat16, *,
                 device=None) -> dict:
    """HF LlamaForCausalLM state dict -> layer-stacked params in ``dtype``
    on ``device`` (default: the card), filled a layer at a time."""
    dev = resolve_device(device)
    shapes = _proj_shapes(cfg)
    layers = {}
    for name in LLAMA_KEYS:
        out = torch.empty((cfg.n_layers, *shapes.get(name, (cfg.dim,))),
                          dtype=dtype, device=dev)
        for i in range(cfg.n_layers):
            out[i].copy_(llama_weight(sd, name, i, dev))
        layers[name] = out
    return {"embed": llama_whole(sd, "embed", dtype, dev),
            "layers": layers,
            "final_norm": llama_whole(sd, "final_norm", dtype, dev),
            "lm_head": llama_whole(sd, "lm_head", dtype, dev)}


# ----------------------------------------------------------------- CLIP ----

def import_clip(sd: dict, cfg: ClipVitConfig, dtype=torch.float32, *,
                device=None) -> dict:
    """HF CLIPVisionModel -> clip_vit params: the embeddings in ``dtype``,
    norms and dense layers fp32 (as the JAX importer leaves them)."""
    dev = resolve_device(device)
    pre = "vision_model."
    if not any(k.startswith(pre) for k in sd):
        pre = ""
    patch_w = _f32(sd[pre + "embeddings.patch_embedding.weight"])
    d = patch_w.shape[0]
    patch = patch_w.reshape(d, -1).t()  # (3*p*p, d), c-major like patchify

    layers = []
    for i in range(cfg.n_layers):
        p = f"{pre}encoder.layers.{i}."
        layers.append({
            "ln1": _lnp(sd, p + "layer_norm1"),
            "q": _lin(sd, p + "self_attn.q_proj"),
            "k": _lin(sd, p + "self_attn.k_proj"),
            "v": _lin(sd, p + "self_attn.v_proj"),
            "out": _lin(sd, p + "self_attn.out_proj"),
            "ln2": _lnp(sd, p + "layer_norm2"),
            "fc1": _lin(sd, p + "mlp.fc1"),
            "fc2": _lin(sd, p + "mlp.fc2"),
        })
    return _to({
        "cls": _f32(sd[pre + "embeddings.class_embedding"]).to(dtype),
        "patch": patch.to(dtype).contiguous(),
        "pos": _f32(sd[pre + "embeddings.position_embedding.weight"]
                    ).to(dtype),
        "pre_ln": _lnp(sd, pre + "pre_layrnorm"),
        "post_ln": _lnp(sd, pre + "post_layernorm"),
        "layers": _stack(layers),
    }, dev)


# ---------------------------------------------------------------- BEATs ----

def fold_weight_norm(g, v, dim: int = 2):
    """torch ``weight_norm(conv, dim=2)``: per-kernel-position norm over the
    remaining dims.  numpy in, numpy out (fp32 math on fp32 input)."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / norm


def import_beats(sd: dict, cfg: BeatsConfig, dtype=torch.float32, *,
                 device=None) -> dict:
    """BEATs checkpoint -> beats params: the patch embedding, positional
    convolution and relative-bias table in ``dtype``, the rest fp32."""
    dev = resolve_device(device)
    patch_w = _f32(sd["patch_embedding.weight"])  # (e, 1, p, p)
    e = patch_w.shape[0]
    patch = patch_w.reshape(e, -1).t()  # (p*p, e)

    pos_w = torch.from_numpy(fold_weight_norm(
        _f32(sd["encoder.pos_conv.0.weight_g"]).numpy(),
        _f32(sd["encoder.pos_conv.0.weight_v"]).numpy(), dim=2))

    layers = []
    for i in range(cfg.encoder_layers):
        p = f"encoder.layers.{i}."
        grep_a = _f32(sd[p + "self_attn.grep_a"]).reshape(-1) if \
            p + "self_attn.grep_a" in sd else torch.ones(cfg.encoder_heads)
        layers.append({
            "q": _lin(sd, p + "self_attn.q_proj"),
            "k": _lin(sd, p + "self_attn.k_proj"),
            "v": _lin(sd, p + "self_attn.v_proj"),
            "out": _lin(sd, p + "self_attn.out_proj"),
            "ln_attn": _lnp(sd, p + "self_attn_layer_norm"),
            "fc1": _lin(sd, p + "fc1"),
            "fc2": _lin(sd, p + "fc2"),
            "ln_final": _lnp(sd, p + "final_layer_norm"),
            "grep": _lin(sd, p + "self_attn.grep_linear") if
                    p + "self_attn.grep_linear.weight" in sd else
                    {"w": torch.zeros((cfg.head_dim, 8)),
                     "b": torch.zeros((8,))},
            "grep_a": grep_a,
        })

    def cast(x):
        return _f32(x).to(dtype)

    return _to({
        "patch": patch.to(dtype).contiguous(),
        "patch_bias": cast(sd["patch_embedding.bias"])
                      if "patch_embedding.bias" in sd else None,
        "frontend_ln": _lnp(sd, "layer_norm"),
        "post_proj": _lin(sd, "post_extract_proj"),
        "pos_conv_w": pos_w.to(dtype),
        "pos_conv_b": cast(sd["encoder.pos_conv.0.bias"]),
        "encoder_ln": _lnp(sd, "encoder.layer_norm"),
        # the shared table lives on layer 0
        "rel_bias": cast(
            sd["encoder.layers.0.self_attn.relative_attention_bias.weight"]),
        "layers": _stack(layers),
    }, dev)


def beats_config_from_ckpt(cfg_dict: dict) -> BeatsConfig:
    """The architecture flags of a BEATs checkpoint's ``cfg``."""
    return BeatsConfig(
        input_patch_size=cfg_dict.get("input_patch_size", 16),
        embed_dim=cfg_dict.get("embed_dim", 512),
        encoder_embed_dim=cfg_dict.get("encoder_embed_dim", 768),
        encoder_layers=cfg_dict.get("encoder_layers", 12),
        encoder_ffn_dim=cfg_dict.get("encoder_ffn_embed_dim", 3072),
        encoder_heads=cfg_dict.get("encoder_attention_heads", 12),
        conv_bias=cfg_dict.get("conv_bias", False),
        deep_norm=cfg_dict.get("deep_norm", False),
        layer_norm_first=cfg_dict.get("layer_norm_first", False),
        relative_position_embedding=cfg_dict.get(
            "relative_position_embedding", False),
        num_buckets=cfg_dict.get("num_buckets", 320),
        max_distance=cfg_dict.get("max_distance", 1280),
        gru_rel_pos=cfg_dict.get("gru_rel_pos", False),
        conv_pos=cfg_dict.get("conv_pos", 128),
        conv_pos_groups=cfg_dict.get("conv_pos_groups", 16),
    )


# -------------------------------------------------------------- QFormer ----

QFORMER_LAYER_KEYS = {  # tree key -> BERT name within encoder.layer.i
    "attn_q": "attention.self.query", "attn_k": "attention.self.key",
    "attn_v": "attention.self.value", "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "cross_q": "crossattention.self.query",
    "cross_k": "crossattention.self.key",
    "cross_v": "crossattention.self.value",
    "cross_out": "crossattention.output.dense",
    "cross_ln": "crossattention.output.LayerNorm",
    "ffn_q_in": "intermediate_query.dense",
    "ffn_q_out": "output_query.dense",
    "ffn_q_ln": "output_query.LayerNorm",
    "ffn_t_in": "intermediate.dense", "ffn_t_out": "output.dense",
    "ffn_t_ln": "output.LayerNorm",
}


def import_qformer(sd: dict, cfg: QFormerConfig, prefix: str = "bert."
                   ) -> dict:
    """A BERT Q-Former state dict -> qformer params on the CPU (fp32);
    ``query_tokens`` is left to the projector importer."""
    layers = []
    for i in range(cfg.n_layers):
        p = f"{prefix}encoder.layer.{i}."
        layers.append({k: (_lnp if k.endswith("_ln") else _lin)(sd, p + v)
                       for k, v in QFORMER_LAYER_KEYS.items()})
    return {
        "word_embed": _f32(sd[prefix + "embeddings.word_embeddings.weight"]),
        "pos_embed": _f32(
            sd[prefix + "embeddings.position_embeddings.weight"]),
        "embed_ln": _lnp(sd, prefix + "embeddings.LayerNorm"),
        "query_tokens": None,  # supplied by the projector importer
        "layers": _stack(layers),
    }


def import_projector(sd: dict, cfg, kind: str = "visual", *,
                     device=None) -> dict:
    """Projector state dict (VLProjector/ALProjector module) -> params.

    ``kind`` selects the reference attribute names: visual_{ln,Qformer,
    query_tokens,proj} or audio_*."""
    dev = resolve_device(device)
    k = kind
    sub = {key[len(f"{k}_Qformer."):]: v for key, v in sd.items()
           if key.startswith(f"{k}_Qformer.")}
    q = import_qformer(sub, cfg.qformer())
    q["query_tokens"] = _f32(sd[f"{k}_query_tokens"]).reshape(
        cfg.num_query_tokens, -1)
    return _to({
        "input_ln": _lnp(sd, f"{k}_ln"),
        "qformer": q,
        "mlp": {"fc1": _lin(sd, f"{k}_proj.0"),
                "fc2": _lin(sd, f"{k}_proj.2")},
    }, dev)


# ------------------------------------------------------------- Adapters ----

_AVT_KEY = re.compile(
    r".*layers\.(\d+)\.(self_attn|mlp)\.(\w+)_proj\.lora_([AB])(\d+)\.weight")

_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def _zero_adapters(cfg: LlamaConfig, num_modalities: int, rank: int,
                   targets) -> dict:
    shapes = _proj_shapes(cfg)
    return {name: {"a": torch.zeros((cfg.n_layers, num_modalities,
                                     shapes[name][0], rank)),
                   "b": torch.zeros((cfg.n_layers, rank, shapes[name][1]))}
            for name in targets}


def import_moka_adapters_avt(sd: dict, cfg: LlamaConfig, num_modalities: int,
                             rank: int, targets=_TARGETS, *,
                             device=None) -> dict:
    """``adapter_model.bin`` (peft_hyper naming ``...q_proj.lora_A0.weight``)
    -> layer-stacked adapter tree (fp32)."""
    dev = resolve_device(device)
    out = _zero_adapters(cfg, num_modalities, rank, targets)
    for key, w in sd.items():
        m = _AVT_KEY.match(key)
        if not m:
            continue
        layer, _, proj, ab, idx = m.groups()
        layer, idx = int(layer), int(idx)
        if proj not in out:
            continue
        if ab == "A":
            out[proj]["a"][layer, idx] = _t(w)  # (r, d_in) -> (d_in, r)
        else:
            out[proj]["b"][layer] = _t(w)       # (d_out, r) -> (r, d_out)
    return {"layers": _to(out, dev)}


_VT_LORA_KEY = re.compile(
    r".*layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)_proj\.lora_([AB])\.(\w+)"
    r"\.weight")


def import_moka_adapters_vt(sd: dict, cfg: LlamaConfig, rank: int,
                            adapters: tuple[str, ...] = ("text", "image"),
                            targets=_TARGETS, *, device=None) -> dict:
    """VT PeftMixedModel naming (``...q_proj.lora_A.image.weight``, shared
    ``lora_B.text.weight``) -> layer-stacked adapter tree.  Modality order
    matches ``MokaSpec.vt``: index 0 = text, 1 = image."""
    dev = resolve_device(device)
    order = {name: i for i, name in enumerate(adapters)}
    out = _zero_adapters(cfg, len(adapters), rank, targets)
    for key, w in sd.items():
        m = _VT_LORA_KEY.match(key)
        if not m:
            continue
        layer, proj, ab, adapter = m.groups()
        layer = int(layer)
        if proj not in out or adapter not in order:
            continue
        if ab == "A":
            out[proj]["a"][layer, order[adapter]] = _t(w)
        elif adapter == "text":  # only lora_B.text is applied
            out[proj]["b"][layer] = _t(w)
    return {"layers": _to(out, dev)}


def strip_to_submodule(sd: dict, sub: str) -> dict:
    """Select keys containing ``sub`` and strip everything up to and
    including it.  Reference artifacts carry stage-dependent wrapper
    prefixes ('base_model.model.model.' from the peft-wrapped fine-tune
    save, 'model.' from stage-1 pretraining) and load with
    ``strict=False``; substring matching is the only prefix-robust
    inverse."""
    out = {}
    for k, v in sd.items():
        i = k.find(sub)
        if i != -1:
            out[k[i + len(sub):]] = v
    return out


def import_vt_trainable(sd: dict, cfg, trainable: dict, *,
                        device=None) -> dict:
    """VT full-state ``model.safetensors`` / ``visual_pretrain.bin`` ->
    {projector, adapters}.  The projector is the reference VLProjector
    mounted as ``multi_modal_projector``, so its keys keep the visual_*
    attribute names under that prefix."""
    proj_sd = {}
    for k, v in sd.items():
        idx = k.find("multi_modal_projector.")
        if idx >= 0:
            proj_sd[k[idx + len("multi_modal_projector."):]] = v
    if proj_sd:
        trainable = dict(trainable)
        trainable["projector"] = import_projector(
            proj_sd, cfg.projector, kind="visual", device=device)
    if any(".lora_A." in k for k in sd):
        trainable = dict(trainable)
        trainable["adapters"] = import_moka_adapters_vt(
            sd, cfg.llama, cfg.spec.rank, device=device)
    return trainable
