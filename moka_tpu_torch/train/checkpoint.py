"""Checkpoints: ``torch.save`` step directories for save and resume, and the
torch-format exports the reference reads (port of
``moka_tpu/train/checkpoint.py``, which saves with orbax).

Three artifact families:
  (a) periodic checkpoints: ``checkpoints/<step>/state.pt`` holding the
      whole ``TrainState`` (step, fp32 params, the optimizer state with its
      gradient-accumulation fields, the dropout key), the newest
      ``max_to_keep`` kept;
  (b) the final split export ``adapter_model.bin`` +
      ``non_lora_trainables.bin`` (``export_torch_artifacts``);
  (c) auto-resume from the newest checkpoint (``latest_step``/``restore``).

A step is written into a temporary directory beside the others and renamed
into place, so ``latest_step`` never sees a half-written step; saving a
step that already exists replaces it.  Only the main process saves
(``save_on_main``: every rank of a group waits at a barrier before and
after the main one writes; the adapters are replicated, so rank 0 holds
all of them).

The exports return ``{name: tensor}`` dicts of CPU tensors with the keys,
shapes and dtypes (fp32; int64 position ids) of the JAX exports.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.parallel.mesh import initialized, process_rank
from moka_tpu_torch.train.import_torch import QFORMER_LAYER_KEYS
from moka_tpu_torch.train.optim import OptState, tree_map
from moka_tpu_torch.train.step import TrainState

_STATE = "state.pt"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit()
                  and os.path.exists(os.path.join(directory, n, _STATE)))


def barrier() -> None:
    """Every rank of the default process group waits here (nothing in one
    process)."""
    if initialized():
        torch.distributed.barrier()


def save_on_main(directory: str, state: TrainState,
                 max_to_keep: int = 3) -> None:
    """``save`` by rank 0 only, between two barriers: no rank runs ahead
    of a save in progress, or reads a step before it is written."""
    barrier()
    if process_rank() == 0:
        save(directory, state, max_to_keep)
    barrier()


def save(directory: str, state: TrainState, max_to_keep: int = 3) -> None:
    step = int(state.step)
    opt = state.opt_state
    payload = {"step": step, "params": _cpu(state.params),
               "opt_state": {"count": opt.count, "mu": _cpu(opt.mu),
                             "nu": _cpu(opt.nu),
                             "mini_step": opt.mini_step,
                             "gradient_step": opt.gradient_step,
                             "acc_grads": _cpu(opt.acc_grads)},
               "rng": state.rng.seed}
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=directory)
    torch.save(payload, os.path.join(tmp, _STATE))
    final = os.path.join(directory, str(step))
    if os.path.exists(final):
        old = tempfile.mkdtemp(prefix=f".old-{step}-", dir=directory)
        os.replace(final, os.path.join(old, "step"))
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    for s in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(s)))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, template: TrainState,
            step: int | None = None) -> TrainState:
    """The checkpoint of ``step`` (default: the newest) with every tensor
    on the device and in the dtype of ``template``'s matching leaf."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    out = torch.load(os.path.join(directory, str(step), _STATE),
                     map_location="cpu", weights_only=True)

    def like(tpl, saved):
        return tree_map(lambda t, s: s.to(device=t.device, dtype=t.dtype),
                        tpl, saved)

    tpl, saved = template.opt_state, out["opt_state"]
    opt = OptState(count=int(saved["count"]), mu=like(tpl.mu, saved["mu"]),
                   nu=like(tpl.nu, saved["nu"]),
                   mini_step=int(saved["mini_step"]),
                   gradient_step=int(saved["gradient_step"]),
                   acc_grads=None if tpl.acc_grads is None else
                   like(tpl.acc_grads, saved["acc_grads"]))
    return TrainState(step=int(out["step"]),
                      params=like(template.params, out["params"]),
                      opt_state=opt, rng=DropoutKey(out["rng"]))


# ------------------------------------------------------- torch export ----

_GROUP = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
          "v": "self_attn.v_proj", "o": "self_attn.o_proj",
          "gate": "mlp.gate_proj", "up": "mlp.up_proj",
          "down": "mlp.down_proj"}


def _f32(x) -> torch.Tensor:
    """An fp32 CPU copy that shares no storage (``torch.save`` writes a
    view's whole storage; safetensors refuses shared tensors)."""
    return x.detach().to(device="cpu", dtype=torch.float32, copy=True)


def _wt(x) -> torch.Tensor:
    """A (d_in, d_out) weight as torch's (out, in), contiguous fp32."""
    return _f32(x).t().contiguous()


def adapters_to_torch_state_dict(adapters: dict,
                                 prefix: str = "base_model.model.model."
                                 ) -> dict:
    """Layer-stacked adapter tree -> peft_hyper-style names
    (``...layers.N.self_attn.q_proj.lora_A0.weight``), inverse of
    ``import_torch.import_moka_adapters_avt``."""
    sd = {}
    for name, p in adapters["layers"].items():
        a, b = p["a"], p["b"]  # (N, M, d_in, r), (N, r, d_out)
        n_layers, n_mod = a.shape[:2]
        for layer in range(n_layers):
            base = f"{prefix}layers.{layer}.{_GROUP[name]}"
            for m in range(n_mod):
                sd[f"{base}.lora_A{m}.weight"] = _wt(a[layer, m])
            sd[f"{base}.lora_B0.weight"] = _wt(b[layer])
    return sd


def export_torch_artifacts(out_dir: str, trainable: dict,
                           stage1: bool = False) -> None:
    """The final split save: ``adapter_model.bin`` (lora params) and
    ``non_lora_trainables.bin`` (projector params).

    Key prefixes follow the reference's ``named_parameters()`` naming at
    save time:

    * stage 2 (default): the model is peft-wrapped, so keys carry
      ``base_model.model.model.``;
    * ``stage1=True``: no peft wrap, keys carry ``model.``, and the
      new-token embedding rows export as ``model.embed_tokens.weight``.
    """
    os.makedirs(out_dir, exist_ok=True)
    if "adapters" in trainable:
        torch.save(adapters_to_torch_state_dict(trainable["adapters"]),
                   os.path.join(out_dir, "adapter_model.bin"))
    non_lora = {}
    wrap = "model." if stage1 else "base_model.model.model."
    for proj_key, ref_prefix, kind in (
            ("vl_projector", f"{wrap}vl_projector.", "visual"),
            ("al_projector", f"{wrap}al_projector.", "audio"),
            ("projector", f"{wrap}multi_modal_projector.", "visual")):
        if proj_key in trainable:
            non_lora.update(projector_to_torch_state_dict(
                trainable[proj_key], kind=kind, prefix=ref_prefix))
    if stage1 and "new_token_embeds" in trainable:
        non_lora[f"{wrap}embed_tokens.weight"] = _f32(
            trainable["new_token_embeds"])
    if non_lora:
        torch.save(non_lora, os.path.join(out_dir,
                                          "non_lora_trainables.bin"))


def projector_to_torch_state_dict(proj: dict, kind: str = "visual",
                                  prefix: str = "") -> dict:
    """Inverse of ``import_torch.import_projector`` (reference attribute
    naming: ``visual_ln/visual_Qformer/visual_query_tokens/visual_proj``)."""
    k = kind
    sd = {}

    def lin(p, name):
        sd[f"{prefix}{name}.weight"] = _wt(p["w"])
        sd[f"{prefix}{name}.bias"] = _f32(p["b"])

    def lnp(p, name):
        sd[f"{prefix}{name}.weight"] = _f32(p["g"])
        sd[f"{prefix}{name}.bias"] = _f32(p["b"])

    lnp(proj["input_ln"], f"{k}_ln")
    sd[f"{prefix}{k}_query_tokens"] = _f32(
        proj["qformer"]["query_tokens"])[None]
    lin(proj["mlp"]["fc1"], f"{k}_proj.0")
    lin(proj["mlp"]["fc2"], f"{k}_proj.2")

    q = proj["qformer"]
    qp = f"{prefix}{k}_Qformer.bert."
    sd[f"{qp}embeddings.word_embeddings.weight"] = _f32(q["word_embed"])
    sd[f"{qp}embeddings.position_embeddings.weight"] = _f32(q["pos_embed"])
    sd[f"{qp}embeddings.LayerNorm.weight"] = _f32(q["embed_ln"]["g"])
    sd[f"{qp}embeddings.LayerNorm.bias"] = _f32(q["embed_ln"]["b"])
    n_layers = q["layers"]["attn_q"]["w"].shape[0]
    for i in range(n_layers):
        for ours, theirs in QFORMER_LAYER_KEYS.items():
            p = q["layers"][ours]
            full = f"{qp}encoder.layer.{i}.{theirs}"
            if ours.endswith("_ln"):
                sd[f"{full}.weight"] = _f32(p["g"][i])
            else:
                sd[f"{full}.weight"] = _wt(p["w"][i])
            sd[f"{full}.bias"] = _f32(p["b"][i])
    return sd


def export_vt_state_dict(trainable: dict, cfg) -> dict:
    """VT trainable -> reference submodule naming
    (``multi_modal_projector.*`` + ``...q_proj.lora_A.{text,image}.weight``
    / ``lora_B.text.weight``): the trainable subset only, which
    round-trips through ``import_torch.import_vt_trainable``.  The full
    state dict the reference eval drivers load strictly is
    ``export_vt_full_state_dict``."""
    sd = {}
    if "projector" in trainable:
        sd.update(projector_to_torch_state_dict(
            trainable["projector"], kind="visual",
            prefix="multi_modal_projector."))
    names = ("text", "image")
    if "adapters" in trainable:
        for name, p in trainable["adapters"]["layers"].items():
            a, b = p["a"], p["b"]
            for layer in range(a.shape[0]):
                base = (f"language_model.model.layers.{layer}."
                        f"{_GROUP[name]}")
                for m, adapter in enumerate(names):
                    sd[f"{base}.lora_A.{adapter}.weight"] = _wt(a[layer, m])
                sd[f"{base}.lora_B.text.weight"] = _wt(b[layer])
    return sd


def save_vt_safetensors(path: str, trainable: dict, cfg) -> None:
    from safetensors.torch import save_file
    save_file(export_vt_state_dict(trainable, cfg), path)


def clip_to_torch_state_dict(clip: dict, cfg,
                             prefix: str = "vision_model.") -> dict:
    """Inverse of ``import_torch.import_clip`` (HF CLIPVisionModel naming,
    the upstream 'pre_layrnorm' spelling included)."""
    sd = {}
    patch = _f32(clip["patch"])       # (3*p*p, d)
    d = patch.shape[1]
    p = cfg.patch_size
    sd[f"{prefix}embeddings.patch_embedding.weight"] = \
        patch.t().reshape(d, 3, p, p).contiguous()
    sd[f"{prefix}embeddings.class_embedding"] = _f32(clip["cls"])
    sd[f"{prefix}embeddings.position_embedding.weight"] = _f32(clip["pos"])

    def lnp(tree, name):
        sd[f"{name}.weight"] = _f32(tree["g"])
        sd[f"{name}.bias"] = _f32(tree["b"])

    lnp(clip["pre_ln"], f"{prefix}pre_layrnorm")
    lnp(clip["post_ln"], f"{prefix}post_layernorm")
    names = {"ln1": "layer_norm1", "q": "self_attn.q_proj",
             "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "out": "self_attn.out_proj", "ln2": "layer_norm2",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    n_layers = clip["layers"]["q"]["w"].shape[0]
    for i in range(n_layers):
        for ours, theirs in names.items():
            t = clip["layers"][ours]
            full = f"{prefix}encoder.layers.{i}.{theirs}"
            if ours.startswith("ln"):
                sd[f"{full}.weight"] = _f32(t["g"][i])
            else:
                sd[f"{full}.weight"] = _wt(t["w"][i])
            sd[f"{full}.bias"] = _f32(t["b"][i])
    return sd


def export_vt_full_state_dict(trainable: dict, frozen: dict, cfg) -> dict:
    """The full PeftMixedModel state dict the reference eval drivers load
    strictly: the frozen CLIP vision tower, the frozen llama base
    (projection weights under ``.base_layer``, dequantized when quantized),
    the lm_head, the Q-Former projector and both dual adapters, all under
    ``base_model.model.`` wrapper prefixes.

    Two key families of the reference module tree are not in this math
    (both unused by its forward): ``visual_Qformer.cls.*`` (the
    BertLMHeadModel head) exports as zeros (unit LayerNorm weight), and
    ``bert.embeddings.position_ids`` is an arange."""
    from moka_tpu_torch.ops.quant import dequantize, is_quantized

    root = "base_model.model."
    inner = f"{root}model."
    sd = clip_to_torch_state_dict(
        frozen["clip"], cfg.clip,
        prefix=f"{inner}vision_tower.vision_model.")

    base = frozen["llama"]
    lm = f"{inner}language_model."
    sd[f"{lm}embed_tokens.weight"] = _f32(base["embed"])
    sd[f"{lm}norm.weight"] = _f32(base["final_norm"])
    lm_w = base["lm_head"]
    if is_quantized(lm_w):  # a head-quantized training tree: dequantized
        lm_w = dequantize(lm_w, dtype=torch.float32)
    sd[f"{root}lm_head.weight"] = _wt(lm_w)
    n_layers = cfg.llama.n_layers
    for name, theirs in _GROUP.items():
        w = base["layers"][name]
        if is_quantized(w):
            w = dequantize(w, dtype=torch.float32)
        for i in range(n_layers):
            sd[f"{lm}layers.{i}.{theirs}.base_layer.weight"] = _wt(w[i])
    for i in range(n_layers):
        sd[f"{lm}layers.{i}.input_layernorm.weight"] = _f32(
            base["layers"]["attn_norm"][i])
        sd[f"{lm}layers.{i}.post_attention_layernorm.weight"] = _f32(
            base["layers"]["mlp_norm"][i])

    # dual adapters (lora_B.image is in the module tree but never applied;
    # zero, as the reference initialises it)
    for name, p in trainable["adapters"]["layers"].items():
        a, b = p["a"], p["b"]   # (N, 2, d_in, r), (N, r, d_out)
        for i in range(n_layers):
            basek = f"{lm}layers.{i}.{_GROUP[name]}"
            sd[f"{basek}.lora_A.text.weight"] = _wt(a[i, 0])
            sd[f"{basek}.lora_A.image.weight"] = _wt(a[i, 1])
            sd[f"{basek}.lora_B.text.weight"] = _wt(b[i])
            sd[f"{basek}.lora_B.image.weight"] = torch.zeros_like(_wt(b[i]))

    proj_prefix = f"{inner}multi_modal_projector."
    sd.update(projector_to_torch_state_dict(
        trainable["projector"], kind="visual", prefix=proj_prefix))
    q = trainable["projector"]["qformer"]
    vocab, hidden = q["word_embed"].shape
    max_pos = q["pos_embed"].shape[0]
    qp = f"{proj_prefix}visual_Qformer."
    sd[f"{qp}bert.embeddings.position_ids"] = torch.arange(
        max_pos, dtype=torch.int64)[None]
    cls = f"{qp}cls.predictions."
    sd[f"{cls}bias"] = torch.zeros((vocab,))
    sd[f"{cls}decoder.weight"] = torch.zeros((vocab, hidden))
    sd[f"{cls}decoder.bias"] = torch.zeros((vocab,))
    sd[f"{cls}transform.dense.weight"] = torch.zeros((hidden, hidden))
    sd[f"{cls}transform.dense.bias"] = torch.zeros((hidden,))
    sd[f"{cls}transform.LayerNorm.weight"] = torch.ones((hidden,))
    sd[f"{cls}transform.LayerNorm.bias"] = torch.zeros((hidden,))
    return sd


def save_vt_full_safetensors(path: str, trainable: dict, frozen: dict,
                             cfg) -> None:
    """``model.safetensors`` loadable by the reference eval drivers
    (strictly, onto a PeftMixedModel)."""
    from safetensors.torch import save_file
    save_file(export_vt_full_state_dict(trainable, frozen, cfg), path)
