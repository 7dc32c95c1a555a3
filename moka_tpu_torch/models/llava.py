"""LLaVA-style bi-modal (image + text) model, the VisualText subproject
(port of ``moka_tpu/models/llava.py``).

The CLIP tower (frozen) gives its layer ``select_layer`` output without
CLS, the visual Q-Former projector (trainable) turns each image into
``num_query_tokens`` decoder tokens, the splice writes them at the image
positions, and the LLaMA decoder runs with the VT MokA adapters
(``MokaSpec.vt``: text and image A matrices, a shared B, the rank-space
attention on the image modality).  Parameters split as in JAX:
  frozen    = {llama, clip}: bf16 (quantized dicts allowed), no gradients;
  trainable = {projector, adapters}: fp32.
The tower runs under ``torch.no_grad()`` (JAX's ``stop_gradient``): no
autograd graph is built through its layers, and it stops after layer
``select_layer`` (23 of ViT-L/14's 24).
"""

from __future__ import annotations

import dataclasses

import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.data.assembler import splice_features
from moka_tpu_torch.models import llama
from moka_tpu_torch.models.clip_vit import (ClipVitConfig,
                                            clip_hidden_states,
                                            init_clip_params)
from moka_tpu_torch.models.projectors import (ProjectorConfig,
                                              init_projector_params,
                                              project_visual)
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.parallel.stream import fetch


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llama: LlamaConfig
    clip: ClipVitConfig
    projector: ProjectorConfig
    spec: MokaSpec
    # hidden_states index for vision features; -2 == layer n_layers-1 output
    # (modelling_llava.py:200-264)
    vision_feature_layer: int = -2

    @staticmethod
    def vt_7b(vocab_size: int = 32000, attn_weight: float = 0.05,
              rank: int = 4, lora_alpha: float = 16.0,
              dropout_rate: float = 0.05) -> "LlavaConfig":
        return LlavaConfig(
            llama=LlamaConfig.llama2_7b(vocab_size=vocab_size),
            clip=ClipVitConfig.vit_l_14(),
            projector=ProjectorConfig.visual(d_model=4096),
            spec=MokaSpec.vt(rank=rank, lora_alpha=lora_alpha,
                             attn_weight=attn_weight,
                             dropout_rate=dropout_rate),
        )

    @staticmethod
    def tiny() -> "LlavaConfig":
        lcfg = LlamaConfig.tiny(vocab_size=256)
        return LlavaConfig(
            llama=lcfg,
            clip=ClipVitConfig.tiny(),
            projector=ProjectorConfig(
                input_width=32, num_query_tokens=4, qformer_hidden=48,
                d_model=lcfg.dim, tokens_per_group=4),
            spec=MokaSpec.vt(rank=4, dropout_rate=0.0),
        )

    @property
    def select_layer(self) -> int:
        n = self.clip.n_layers
        return n + 1 + self.vision_feature_layer if \
            self.vision_feature_layer < 0 else self.vision_feature_layer


def init_frozen(generator: torch.Generator, cfg: LlavaConfig, *,
                device=None, dtype=torch.bfloat16) -> dict:
    """Random {llama, clip} in ``dtype``."""
    kw = dict(device=device, dtype=dtype)
    return {"llama": llama.init_llama_params(generator, cfg.llama, **kw),
            "clip": init_clip_params(generator, cfg.clip, **kw)}


def init_trainable(generator: torch.Generator, cfg: LlavaConfig, *,
                   device=None) -> dict:
    """The fp32 projector and MokA VT adapters (B zero)."""
    return {"projector": init_projector_params(generator, cfg.projector,
                                               device=device),
            "adapters": llama.init_moka_adapters(generator, cfg.llama,
                                                 cfg.spec, device=device)}


def image_features(trainable: dict, frozen: dict, cfg: LlavaConfig,
                   pixel_values: torch.Tensor) -> torch.Tensor:
    """(b, 3, H, W) -> (b, num_query_tokens, d_model): CLIP layer
    ``select_layer``, CLS dropped, in fp32 through the Q-Former projector
    (trainable)."""
    clip = frozen["clip"]
    with torch.no_grad():
        feats = clip_hidden_states(clip, cfg.clip,
                                   pixel_values.to(clip["patch"].dtype),
                                   (cfg.select_layer,))[0].float()
    return project_visual(trainable["projector"], cfg.projector, feats)


def build_inputs_embeds(trainable: dict, frozen: dict, cfg: LlavaConfig,
                        batch: dict) -> torch.Tensor:
    """Token embeddings with the image tokens spliced in at
    ``image_pos`` when the batch has ``pixel_values`` (the table fetched
    whole: ``parallel.stream.fetch``)."""
    ids = batch["ids"].long()
    embeds = fetch(frozen["llama"]["embed"], ids.device)[ids]
    if "pixel_values" in batch:
        feats = image_features(trainable, frozen, cfg, batch["pixel_values"])
        embeds = splice_features(embeds, video_features=feats,
                                 video_pos=batch["image_pos"])
    return embeds


def _masks(batch: dict) -> llama.MaskBundle:
    """The VT modality masks, text then image, and the question mask."""
    mod = torch.stack([batch["text_mask"], batch["image_mask"]])
    return llama.MaskBundle(mod, batch["question_mask"])


def llava_loss(cfg: LlavaConfig, remat: bool = True,
               use_flash: bool = False, fused_loss: bool = False,
               remat_policy: str | None = None,
               a8_dots: bool | str = False,
               save_q8: bool | tuple = False, mesh=None,
               host_stream: dict | None = None):
    """Loss closure for ``train.step.make_train_step``:
    loss_fn(trainable, frozen, batch, rng) -> (loss, {"supervised_tokens"}).
    ``fused_loss``: the chunked lm_head + CE (the a8 head product with
    ``a8_dots``); the other options as ``llama.forward``'s; ``mesh`` and
    ``host_stream`` as ``unified.unified_loss``'s."""
    from moka_tpu_torch.train.objectives import decoder_loss

    def loss_fn(trainable, frozen, batch, rng):
        embeds = build_inputs_embeds(trainable, frozen, cfg, batch)
        return decoder_loss(
            frozen["llama"], cfg.llama, batch["labels"], mesh, rng,
            dict(adapters=trainable["adapters"], spec=cfg.spec,
                 inputs_embeds=embeds, masks=_masks(batch),
                 attn_mask=batch.get("attn_mask"),
                 positions=batch.get("positions"), remat=remat,
                 remat_policy=remat_policy, use_flash=use_flash,
                 a8_dots=a8_dots, save_q8=save_q8, host_stream=host_stream),
            dropout=cfg.spec.dropout_rate > 0, fused_loss=fused_loss,
            a8=a8_dots)

    return loss_fn


@torch.no_grad()
def generate(trainable: dict, frozen: dict, cfg: LlavaConfig, batch: dict,
             max_new_tokens: int, eos_id: int, pad_id: int = 0,
             kv_quant: bool = False) -> torch.Tensor:
    """Greedy generation of left-padded prompts: the tower, projector and
    splice, then the masked MokA prefill and the text-adapter decode loop
    (``eval.decode.greedy_generate`` with its defaults: the flash and
    fused-MokA kernels for CUDA tensors, the paged decode attention where
    ``decode.paged_decode_auto`` says so).  ``kv_quant`` stores the decode
    cache int8.  Returns (b, max_new_tokens) int32."""
    from moka_tpu_torch.eval.decode import greedy_generate
    embeds = build_inputs_embeds(trainable, frozen, cfg, batch)
    return greedy_generate(
        frozen["llama"], trainable["adapters"], cfg=cfg.llama, spec=cfg.spec,
        inputs_embeds=embeds, prompt_mask=batch["attn_mask"],
        masks=_masks(batch), max_new_tokens=max_new_tokens, eos_id=eos_id,
        pad_id=pad_id, kv_quant=kv_quant)
