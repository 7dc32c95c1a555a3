"""The tri-modal AVT model: the CLIP tower and the VL projector, BEATs and
the AL projector, the feature splice and the MokA-adapted LLaMA decoder
(port of ``moka_tpu/models/unified.py``).

Parameters split as in JAX:
  frozen    = {llama, clip, beats}: bf16 (quantized dicts allowed), no
              gradients;
  trainable = {adapters, vl_projector, al_projector[, new_token_embeds]}:
              fp32.
Stage 1 trains only the projectors (``train_adapters=False``); stage 2
the projectors and the adapters.  The towers run under ``torch.no_grad()``
(JAX's ``stop_gradient``): no autograd graph is built through their 24 +
12 layers.  Under a mesh (``mesh=``) each rank holds its own samples: the
batch constraints JAX's ``mesh`` option sets have nothing to do, and the
loss is the rank's share of the global loss (``train.objectives``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.data.assembler import splice_features
from moka_tpu_torch.models import llama
from moka_tpu_torch.models.beats import (BeatsConfig, encode_audio_segments,
                                         init_beats_params)
from moka_tpu_torch.models.clip_vit import (ClipVitConfig, encode_video,
                                            init_clip_params)
from moka_tpu_torch.models.projectors import (ProjectorConfig,
                                              init_projector_params,
                                              project_audio, project_visual)
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.parallel.stream import fetch


@dataclasses.dataclass(frozen=True)
class UnifiedConfig:
    llama: LlamaConfig
    clip: ClipVitConfig
    beats: BeatsConfig
    vl_projector: ProjectorConfig
    al_projector: ProjectorConfig
    spec: MokaSpec | None
    # CLIP hidden states selected; only the last one is projected
    select_layers: tuple[int, ...] = (14, 23)

    @staticmethod
    def avt(llama_cfg: LlamaConfig, spec: MokaSpec | None = None
            ) -> "UnifiedConfig":
        """The AVT stack over a LLaMA base."""
        return UnifiedConfig(
            llama=llama_cfg, clip=ClipVitConfig.vit_l_14(),
            beats=BeatsConfig(),
            vl_projector=ProjectorConfig.visual(d_model=llama_cfg.dim),
            al_projector=ProjectorConfig.audio(d_model=llama_cfg.dim),
            spec=spec if spec is not None else MokaSpec.avt(rank=4))

    @staticmethod
    def avt_7b(vocab_size: int = 32011, spec: MokaSpec | None = None
               ) -> "UnifiedConfig":
        return UnifiedConfig.avt(LlamaConfig.llama2_7b(
            vocab_size=vocab_size), spec)

    @staticmethod
    def tiny(spec: MokaSpec | None = None) -> "UnifiedConfig":
        lcfg = LlamaConfig.tiny(vocab_size=256)
        return UnifiedConfig(
            llama=lcfg, clip=ClipVitConfig.tiny(), beats=BeatsConfig.tiny(),
            vl_projector=ProjectorConfig(
                input_width=32, num_query_tokens=4, qformer_hidden=48,
                d_model=lcfg.dim, tokens_per_group=4),
            al_projector=ProjectorConfig(
                input_width=48, num_query_tokens=4, qformer_hidden=48,
                d_model=lcfg.dim, tokens_per_group=-1),
            spec=spec if spec is not None else
            MokaSpec.avt(rank=4, dropout_rate=0.0),
            select_layers=(1, 2))


def init_frozen(generator: torch.Generator, cfg: UnifiedConfig, *,
                device=None, dtype=torch.bfloat16) -> dict:
    """Random {llama, clip, beats} in ``dtype``."""
    kw = dict(device=device, dtype=dtype)
    return {"llama": llama.init_llama_params(generator, cfg.llama, **kw),
            "clip": init_clip_params(generator, cfg.clip, **kw),
            "beats": init_beats_params(generator, cfg.beats, **kw)}


def init_trainable(generator: torch.Generator, cfg: UnifiedConfig,
                   with_adapters: bool = True, n_new_token_embeds: int = 0,
                   frozen: dict | None = None, *, device=None) -> dict:
    """The fp32 projectors, the MokA adapters (``with_adapters`` and a
    spec) and, with ``n_new_token_embeds``, trainable embedding rows for
    the appended special tokens: the last rows of ``frozen``'s table when
    it is given, else normal(0.02)."""
    out = {"vl_projector": init_projector_params(
               generator, cfg.vl_projector, device=device),
           "al_projector": init_projector_params(
               generator, cfg.al_projector, device=device)}
    if with_adapters and cfg.spec is not None:
        out["adapters"] = llama.init_moka_adapters(
            generator, cfg.llama, cfg.spec, device=device)
    if n_new_token_embeds > 0:
        if frozen is not None:
            rows = frozen["llama"]["embed"][-n_new_token_embeds:]
            out["new_token_embeds"] = rows.float().clone()
        else:
            out["new_token_embeds"] = torch.randn(
                (n_new_token_embeds, cfg.llama.dim), generator=generator,
                device=resolve_device(device)) * 0.02
    return out


def encode_modalities(trainable: dict, frozen: dict, cfg: UnifiedConfig,
                      video: torch.Tensor | None,
                      audio: torch.Tensor | None,
                      question_ids: torch.Tensor | None = None,
                      question_text_mask: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """video (b, t, 3, H, W) -> (b, t*32, d); audio (b, t, T, 128) fbank ->
    (b, t*32, d).  The towers run in their ``patch`` dtype under
    ``no_grad``; the last selected CLIP layer and the BEATs output go to
    the projectors in fp32.  ``question_ids``/``question_text_mask``: an
    optional BERT-tokenised question for the Q-Formers."""
    video_tokens = audio_tokens = None
    q = dict(question_ids=question_ids, question_mask=question_text_mask)
    if video is not None:
        clip = frozen["clip"]
        with torch.no_grad():
            feats = encode_video(clip, cfg.clip, video.to(clip["patch"].dtype),
                                 cfg.select_layers)[-1].float()
        video_tokens = project_visual(trainable["vl_projector"],
                                      cfg.vl_projector, feats, **q)
    if audio is not None:
        beats = frozen["beats"]
        with torch.no_grad():
            feats = encode_audio_segments(
                beats, cfg.beats, audio.to(beats["patch"].dtype)).float()
        audio_tokens = project_audio(trainable["al_projector"],
                                     cfg.al_projector, feats, **q)
    return video_tokens, audio_tokens


def build_inputs_embeds(trainable: dict, frozen: dict, cfg: UnifiedConfig,
                        batch: dict, mesh=None,
                        batch_axes=("data", "fsdp")) -> torch.Tensor:
    """Token embeddings (the trainable rows over the appended special
    tokens) with the projector outputs spliced in at ``video_pos`` and
    ``audio_pos``.  The table is fetched whole (``parallel.stream.fetch``:
    gathered if fsdp-sharded, copied if in host memory).  ``mesh`` and
    ``batch_axes`` are JAX's: each rank's batch is its own samples, so
    there is no constraint to set."""
    ids = batch["ids"].long()
    embeds = fetch(frozen["llama"]["embed"], ids.device)[ids]
    if "new_token_embeds" in trainable:
        new = trainable["new_token_embeds"]
        base = cfg.llama.vocab_size - new.shape[0]
        overlay = new[torch.clamp(ids - base, 0, new.shape[0] - 1)]
        embeds = torch.where((ids >= base)[..., None],
                             overlay.to(embeds.dtype), embeds)
    video_tokens, audio_tokens = encode_modalities(
        trainable, frozen, cfg, batch.get("video"), batch.get("audio"),
        question_ids=batch.get("qformer_question_ids"),
        question_text_mask=batch.get("qformer_question_mask"))
    return splice_features(embeds, video_features=video_tokens,
                           video_pos=batch.get("video_pos"),
                           audio_features=audio_tokens,
                           audio_pos=batch.get("audio_pos"))


def unified_loss(cfg: UnifiedConfig, remat: bool = True,
                 train_adapters: bool = True, use_flash: bool = False,
                 fused_loss: bool = False, remat_policy: str | None = None,
                 mesh=None, batch_axes=("data", "fsdp"),
                 a8_dots: bool | str = False,
                 save_q8: bool | tuple = False,
                 host_stream: dict | None = None):
    """Loss closure for ``train.step.make_train_step``:
    loss_fn(trainable, frozen, batch, rng) -> (loss, {"supervised_tokens"}).
    ``train_adapters=False`` is stage 1: the decoder runs without adapter
    deltas.  ``fused_loss``: the chunked lm_head + CE (128 positions, the
    a8 head product with ``a8_dots``); the other options as
    ``llama.forward``'s.  ``mesh``: the rank's share of the global loss, as
    ``train.objectives.make_llama_moka_loss(mesh=...)`` (with a model axis
    the decoder runs tensor-parallel while the towers, Q-Formers and
    projectors run whole on every rank of a model group, so their
    gradients are whole there); ``host_stream``: the LLaMA base in pinned
    host memory, streamed per layer."""
    from moka_tpu_torch.train.objectives import decoder_loss

    def loss_fn(trainable, frozen, batch, rng):
        embeds = build_inputs_embeds(trainable, frozen, cfg, batch,
                                     mesh=mesh, batch_axes=batch_axes)
        adapters = trainable.get("adapters") if train_adapters else None
        spec = cfg.spec if adapters is not None else None
        masks = llama.MaskBundle(batch["modality_masks"],
                                 batch["question_mask"])
        return decoder_loss(
            frozen["llama"], cfg.llama, batch["labels"], mesh, rng,
            dict(adapters=adapters, spec=spec, inputs_embeds=embeds,
                 masks=masks if adapters is not None else None,
                 attn_mask=batch["attn_mask"], positions=batch["positions"],
                 remat=remat, remat_policy=remat_policy, use_flash=use_flash,
                 a8_dots=a8_dots, save_q8=save_q8, host_stream=host_stream),
            dropout=bool(spec and spec.dropout_rate > 0),
            fused_loss=fused_loss, a8=a8_dots)

    return loss_fn


@torch.no_grad()
def generate(trainable: dict, frozen: dict, cfg: UnifiedConfig, batch: dict,
             max_new_tokens: int, eos_id: int, pad_id: int = 0,
             temperature=0.0, top_k=0, top_p=1.0,
             generator: torch.Generator | None = None,
             kv_quant: bool = False) -> torch.Tensor:
    """Multimodal generation: the towers, projectors and splice, then the
    masked MokA prefill and the text-adapter decode loop
    (``eval.decode``).  Greedy unless some ``temperature`` is above 0
    (scalars or per-row (b,) values, with top-k / top-p); ``kv_quant``
    stores the decode cache int8 (half the cache bytes a step reads).  The
    decode steps take the paged decode attention where
    ``decode.paged_decode_auto`` says so.  Returns (b, max_new_tokens)
    int32."""
    from moka_tpu_torch.eval.decode import greedy_generate, sample_generate
    embeds = build_inputs_embeds(trainable, frozen, cfg, batch)
    masks = llama.MaskBundle(batch["modality_masks"], batch["question_mask"])
    common = dict(cfg=cfg.llama, spec=cfg.spec, inputs_embeds=embeds,
                  prompt_mask=batch["attn_mask"], masks=masks,
                  max_new_tokens=max_new_tokens, eos_id=eos_id,
                  pad_id=pad_id, kv_quant=kv_quant)
    temps = temperature.cpu() if torch.is_tensor(temperature) else temperature
    if np.any(np.asarray(temps) > 0):
        return sample_generate(
            frozen["llama"], trainable.get("adapters"), generator=generator,
            temperature=temperature, top_k=top_k, top_p=top_p, **common)
    return greedy_generate(frozen["llama"], trainable.get("adapters"),
                           **common)
