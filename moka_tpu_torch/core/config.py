"""Decoder and training configs and config snapshots (port of
``moka_tpu/core/config.py``).

``LlamaConfig`` with its presets, ``MeshConfig``, ``PrecisionConfig``,
``TrainConfig`` and ``dump_config``, with the JAX package's fields and
defaults.  Frozen dataclasses, so configs hash and compare cleanly.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


def _asdict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(o) for o in obj]
    return obj


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-2 decoder config (same fields and defaults as the JAX one)."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    rope_theta: float = 10000.0
    # RoPE scaling: None | ("linear", factor) | ("dynamic", factor)
    rope_scaling: tuple[str, float] | None = None
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b(vocab_size: int = 32000) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size)

    @staticmethod
    def llama2_13b(vocab_size: int = 32000) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=5120, n_layers=40,
                           n_heads=40, n_kv_heads=40, intermediate=13824)

    @staticmethod
    def llama_34b(vocab_size: int = 32000) -> "LlamaConfig":
        """CodeLlama-34B dims."""
        return LlamaConfig(vocab_size=vocab_size, dim=8192, n_layers=48,
                           n_heads=64, n_kv_heads=8, intermediate=22016,
                           max_seq_len=4096, rope_theta=1e6)

    @staticmethod
    def llama2_70b(vocab_size: int = 32000) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=8192, n_layers=80,
                           n_heads=64, n_kv_heads=8, intermediate=28672,
                           max_seq_len=4096)

    @staticmethod
    def tiny(vocab_size: int = 256, n_layers: int = 2) -> "LlamaConfig":
        """Small config for tests: 2 layers, dim 64, GQA 4:2."""
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=n_layers,
                           n_heads=4, n_kv_heads=2, intermediate=128,
                           max_seq_len=256)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes: ``data`` = pure data parallel, ``fsdp`` =
    parameter-sharded data parallel, ``model`` = tensor parallel.  In the
    port one rank (process) holds one device; ``parallel.mesh.make_mesh``
    lays the ranks out on these axes (their product is the world size).
    ``model`` above 1 splits each decoder layer's projections over that
    many ranks (``parallel.tensor``), whose samples are the same."""

    data: int = 1
    fsdp: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.model


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """bf16 compute with an fp32 master copy and optimizer state."""

    param_dtype: str = "float32"       # master copy of trainables
    frozen_dtype: str = "bfloat16"     # frozen base weights
    compute_dtype: str = "bfloat16"
    softmax_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer and loop settings (same fields and defaults as the JAX
    one): AdamW with fp32 state, warmup + cosine schedule, global-norm
    clipping, gradient accumulation over ``grad_accum`` micro-steps."""

    learning_rate: float = 1e-4
    lr_schedule: str = "cosine"        # cosine | linear | constant
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    num_epochs: int = 3
    global_batch_size: int = 32
    grad_accum: int = 1
    seed: int = 42
    remat: bool = True                 # gradient checkpointing per layer
    remat_policy: str | None = None    # see models.llama.REMAT_POLICIES
    rng_impl: str | None = None        # a JAX PRNG choice: recorded in
                                       # saved_config.json, one dropout
                                       # generator here (core.rng)
    log_every: int = 1
    save_every_steps: float = 0        # 0 = only final; 0<x<1 = fraction
                                       # of total steps
    adalora_budget: int = 0            # >0: the AdaLoRA rank allocator
    adalora_update_every: int = 100
    output_dir: str = "runs/default"


def dump_config(cfg, path: str) -> None:
    """Write a config (any dataclass tree) as indented JSON."""
    with open(path, "w") as f:
        json.dump(_asdict(cfg), f, indent=2, default=str)
