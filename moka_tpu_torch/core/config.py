"""Decoder config and config snapshots (port of ``moka_tpu/core/config.py``).

Only what the serving slice needs: ``LlamaConfig`` with the presets the
port runs, and ``dump_config``.  Frozen dataclasses, so configs hash and
compare cleanly.
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
    def tiny(vocab_size: int = 256, n_layers: int = 2) -> "LlamaConfig":
        """Small config for tests: 2 layers, dim 64, GQA 4:2."""
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=n_layers,
                           n_heads=4, n_kv_heads=2, intermediate=128,
                           max_seq_len=256)


def dump_config(cfg, path: str) -> None:
    """Write a config (any dataclass tree) as indented JSON."""
    with open(path, "w") as f:
        json.dump(_asdict(cfg), f, indent=2, default=str)
