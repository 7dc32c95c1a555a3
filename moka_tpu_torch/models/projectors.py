"""The VL and AL projectors: input LayerNorm -> 2-layer Q-Former -> 2-layer
MLP to the decoder's width (port of ``moka_tpu/models/projectors.py``).
Trainable, fp32; each group of encoder tokens (a frame, an audio segment)
becomes ``num_query_tokens`` decoder tokens."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.models.layers import dense, layer_norm
from moka_tpu_torch.models.qformer import (QFormerConfig,
                                           init_qformer_params,
                                           qformer_encode)

INPUT_LN_EPS = 1e-5  # nn.LayerNorm's default, not the Q-Former's 1e-12


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    input_width: int = 1024         # 1024 CLIP / 768 BEATs
    num_query_tokens: int = 32
    qformer_layers: int = 2
    qformer_hidden: int = 768
    qformer_heads: int = 12
    qformer_intermediate: int = 3072
    d_model: int = 4096
    tokens_per_group: int = 256     # CLIP patches per frame; -1 for audio
    ln_eps: float = 1e-12

    def qformer(self) -> QFormerConfig:
        return QFormerConfig(hidden=self.qformer_hidden,
                             n_layers=self.qformer_layers,
                             n_heads=self.qformer_heads,
                             intermediate=self.qformer_intermediate,
                             encoder_width=self.input_width,
                             num_query_tokens=self.num_query_tokens)

    @staticmethod
    def visual(d_model: int = 4096) -> "ProjectorConfig":
        return ProjectorConfig(input_width=1024, tokens_per_group=256,
                               d_model=d_model)

    @staticmethod
    def audio(d_model: int = 4096) -> "ProjectorConfig":
        return ProjectorConfig(input_width=768, tokens_per_group=-1,
                               d_model=d_model)


def init_projector_params(generator: torch.Generator, cfg: ProjectorConfig,
                          *, device=None) -> dict:
    """Random fp32 init as JAX's; ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    h, d = cfg.qformer_hidden, cfg.d_model

    def lin(a, b):
        return {"w": torch.randn((a, b), generator=generator, device=dev)
                * 0.02, "b": torch.zeros((b,), device=dev)}

    return {"input_ln": {"g": torch.ones((cfg.input_width,), device=dev),
                         "b": torch.zeros((cfg.input_width,), device=dev)},
            "qformer": init_qformer_params(generator, cfg.qformer(),
                                           device=dev),
            "mlp": {"fc1": lin(h, d), "fc2": lin(d, d)}}


def _project(params: dict, cfg: ProjectorConfig, groups: torch.Tensor,
             b: int, question_ids, question_mask) -> torch.Tensor:
    """(b*t, n, width) groups -> (b, t*num_query_tokens, d_model); the
    question, when given, goes with every group of its sample."""
    t = groups.shape[0] // b
    x = layer_norm(groups, params["input_ln"], INPUT_LN_EPS)
    qi = qm = None
    if question_ids is not None:
        qi = torch.repeat_interleave(question_ids, t, dim=0)
        qm = torch.repeat_interleave(question_mask, t, dim=0)
    q = qformer_encode(params["qformer"], cfg.qformer(), x, text_ids=qi,
                       text_mask=qm)
    mlp = params["mlp"]
    out = dense(F.gelu(dense(q, mlp["fc1"])), mlp["fc2"])
    return out.reshape(b, t * cfg.num_query_tokens, cfg.d_model)


def project_visual(params: dict, cfg: ProjectorConfig,
                   features: torch.Tensor,
                   question_ids: torch.Tensor | None = None,
                   question_mask: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """(b, t*n, width) CLIP features -> (b, t*32, d_model)."""
    b, tn, w = features.shape
    t = tn // cfg.tokens_per_group
    groups = features.reshape(b * t, cfg.tokens_per_group, w)
    return _project(params, cfg, groups, b, question_ids, question_mask)


def project_audio(params: dict, cfg: ProjectorConfig,
                  features: torch.Tensor,
                  question_ids: torch.Tensor | None = None,
                  question_mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """(b, t, n, width) BEATs features -> (b, t*32, d_model)."""
    b, t, n, w = features.shape
    return _project(params, cfg, features.reshape(b * t, n, w), b,
                    question_ids, question_mask)
