"""LLaMA-2 decoder with MokA adapter slots (port of
``moka_tpu/models/llama.py``, serving subset).

Parameters keep the JAX layout: layer-stacked dicts (a leading
``n_layers`` axis) with ``(d_in, d_out)`` projection matrices, so a JAX tree
converts with ``convert.params_from_numpy`` and no renaming.  The layer
``scan``/``fori_loop`` becomes a Python loop that indexes the stacked
tensors.  Every one of the seven projections goes through ``_apply_proj``
(frozen matmul + MokA delta).

Not ported in this slice (each raises ``NotImplementedError``): quantized
bases and int8 KV caches, dropout, remat, ``host_stream``,
``context_parallel`` and ``paged_decode`` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.ops.attention import causal_bias, mha
from moka_tpu_torch.ops.flash_attention import flash_mha
from moka_tpu_torch.ops.moka import (MokaSpec, decode_scale, lora_delta,
                                     moka_delta)
from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
from moka_tpu_torch.ops.rope import apply_rope, rope_cos_sin

PROJ_DIMS = {  # name -> (d_in_attr, d_out_attr)
    "q": ("dim", "q_out"), "k": ("dim", "kv_out"), "v": ("dim", "kv_out"),
    "o": ("q_out", "dim"), "gate": ("dim", "intermediate"),
    "up": ("dim", "intermediate"), "down": ("intermediate", "dim"),
}

_NOT_PORTED = "{} is not ported yet (ROADMAP.md, {})"


def _proj_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    dims = {"dim": cfg.dim, "q_out": cfg.n_heads * cfg.head_dim,
            "kv_out": cfg.n_kv_heads * cfg.head_dim,
            "intermediate": cfg.intermediate}
    return {k: (dims[a], dims[b]) for k, (a, b) in PROJ_DIMS.items()}


def init_llama_params(generator: torch.Generator, cfg: LlamaConfig, *,
                      device=None, dtype=torch.bfloat16) -> dict:
    """Random init (normal 0.02, drawn in fp32 then cast); ``generator``
    must live on ``device`` (default: the card)."""
    dev = resolve_device(device)
    shapes = _proj_shapes(cfg)
    n = cfg.n_layers

    def w(shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * 0.02).to(dtype)

    layers = {name: w((n, *shapes[name])) for name in shapes}
    layers["attn_norm"] = torch.ones((n, cfg.dim), dtype=dtype, device=dev)
    layers["mlp_norm"] = torch.ones((n, cfg.dim), dtype=dtype, device=dev)
    return {
        "embed": w((cfg.vocab_size, cfg.dim)),
        "layers": layers,
        "final_norm": torch.ones((cfg.dim,), dtype=dtype, device=dev),
        "lm_head": w((cfg.dim, cfg.vocab_size)),
    }


def init_moka_adapters(generator: torch.Generator, cfg: LlamaConfig,
                       spec: MokaSpec, *, device=None, dtype=torch.float32,
                       targets: tuple[str, ...] = tuple(PROJ_DIMS)) -> dict:
    """Layer-stacked MokA params for each target projection:
    kaiming-uniform A (bound 1/sqrt(d_in)), zero B (a no-op until
    trained)."""
    dev = resolve_device(device)
    shapes = _proj_shapes(cfg)
    n = cfg.n_layers
    out = {}
    for name in targets:
        d_in, d_out = shapes[name]
        bound = 1.0 / math.sqrt(d_in)
        a = torch.rand((n, spec.num_modalities, d_in, spec.rank),
                       generator=generator, device=dev,
                       dtype=torch.float32) * (2 * bound) - bound
        out[name] = {"a": a.to(dtype),
                     "b": torch.zeros((n, spec.rank, d_out), dtype=dtype,
                                      device=dev)}
    return {"layers": out}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in fp32, cast to x's dtype, then multiply by w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


@dataclasses.dataclass(frozen=True)
class MaskBundle:
    """Token-level modality masks for one batch.

    modality: (M, b, L) 0/1 with index 0 the text; question: (b, L) 0/1."""
    modality: torch.Tensor
    question: torch.Tensor


def _apply_proj(name: str, x: torch.Tensor, base_w, adapters: dict | None,
                spec: MokaSpec | None, masks: MaskBundle | None,
                fused: bool = False) -> torch.Tensor:
    """Frozen projection ``x @ base_w`` plus the adapter delta: the text
    adapter alone when masks are None (decode steps), else the MokA delta
    (the fused kernel when ``fused``)."""
    if isinstance(base_w, dict):
        raise NotImplementedError(_NOT_PORTED.format(
            "a quantized base", "frozen-base quantization"))
    y = torch.matmul(x, base_w)
    if adapters is None or name not in adapters:
        return y
    a, b = adapters[name]["a"], adapters[name]["b"]
    if masks is None:
        return y + lora_delta(x, a[0], b, decode_scale(spec))
    if fused:
        return y + moka_delta_fused(x, a, b, masks.modality, masks.question,
                                    spec)
    return y + moka_delta(x, a, b, masks.modality, masks.question, spec)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, quantized: bool = False, *,
                  device=None) -> dict:
    """Zeroed (n_layers, batch, max_len, n_kv_heads, head_dim) k/v caches;
    ``length`` is a host int (the next write position)."""
    if quantized:
        raise NotImplementedError(_NOT_PORTED.format("the int8 KV cache",
                                                     "decode"))
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": 0}


def _kv_update(side: torch.Tensor, new: torch.Tensor, layer_idx: int,
               pos: int) -> None:
    """Write ``new`` (b, L, K, hd) into layer ``layer_idx`` of one cache
    side at positions [pos, pos + L), in place."""
    if isinstance(side, dict):
        raise NotImplementedError(_NOT_PORTED.format("the int8 KV cache",
                                                     "decode"))
    side[layer_idx, :, pos:pos + new.shape[1]] = new.to(side.dtype)


def _kv_layer(side: torch.Tensor, layer_idx: int,
              dtype: torch.dtype) -> torch.Tensor:
    """One layer's (b, S, K, hd) slice in ``dtype``."""
    if isinstance(side, dict):
        raise NotImplementedError(_NOT_PORTED.format("the int8 KV cache",
                                                     "decode"))
    return side[layer_idx].to(dtype)


def kv_cache_shape(cache: dict) -> tuple:
    """(n_layers, batch, S, K, hd)."""
    if isinstance(cache["k"], dict):
        raise NotImplementedError(_NOT_PORTED.format("the int8 KV cache",
                                                     "decode"))
    return tuple(cache["k"].shape)


def _decoder_layer(cfg: LlamaConfig, spec: MokaSpec | None, use_flash: bool,
                   use_fused_moka: bool, h: torch.Tensor, layer: dict,
                   adapters: dict | None, masks: MaskBundle | None,
                   bias: torch.Tensor | None, attn_mask: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, cache: dict | None,
                   layer_idx: int) -> torch.Tensor:
    """One decoder block; with a cache, writes this layer's k/v into it in
    place and attends over the whole cache."""
    b, L, _ = h.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def proj(name, x):
        return _apply_proj(name, x, layer[name], adapters, spec, masks,
                           fused=use_fused_moka)

    x = rmsnorm(h, layer["attn_norm"], cfg.rms_eps)
    q = apply_rope(proj("q", x).reshape(b, L, H, hd), cos, sin)
    k = apply_rope(proj("k", x).reshape(b, L, K, hd), cos, sin)
    v = proj("v", x).reshape(b, L, K, hd)

    q_offset = 0
    if cache is not None:
        q_offset = cache["length"]
        _kv_update(cache["k"], k, layer_idx, q_offset)
        _kv_update(cache["v"], v, layer_idx, q_offset)
        k = _kv_layer(cache["k"], layer_idx, q.dtype)
        v = _kv_layer(cache["v"], layer_idx, q.dtype)

    if use_flash:
        attn = flash_mha(q, k, v, attn_mask, q_offset=q_offset)
    else:
        attn = mha(q, k, v, bias)
    h = h + proj("o", attn.reshape(b, L, H * hd))

    x = rmsnorm(h, layer["mlp_norm"], cfg.rms_eps)
    gate = proj("gate", x)
    up = proj("up", x)
    act = F.silu(gate.float()).to(up.dtype) * up
    return h + proj("down", act)


def forward(base: dict, cfg: LlamaConfig, *,
            adapters: dict | None = None, spec: MokaSpec | None = None,
            tokens: torch.Tensor | None = None,
            inputs_embeds: torch.Tensor | None = None,
            masks: MaskBundle | None = None,
            attn_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None,
            cache: dict | None = None,
            remat: bool = False, remat_policy: str | None = None,
            dropout_rng=None, logits: bool = True,
            use_flash: bool = False, use_fused_moka: bool = False,
            paged_decode: bool = False, a8_dots: bool | str = False,
            save_q8: bool | tuple = False, context_parallel=None,
            host_stream: dict | None = None):
    """Full decoder forward.

    attn_mask: (b, S) valid-key mask over the attention span (the current
      sequence without a cache; the whole cache with one).
    positions: (b, L) RoPE positions of the current tokens (default arange).
    cache: from ``init_kv_cache``.  The cached forward writes the new k/v
      into ``cache["k"]``/``cache["v"]`` IN PLACE at [length, length + L)
      and returns a new dict holding the same tensors with ``length``
      advanced; the caller's dict is not modified otherwise.
    use_flash: attention through ``flash_mha`` (the CUDA kernel on the card).
    use_fused_moka: MokA deltas through ``moka_delta_fused``.
    Returns (fp32 logits, or the final-normed hidden state when
    ``logits=False``; the new cache or None).
    """
    for flag, value, item in (
            ("remat", remat or remat_policy is not None, "remat policies"),
            ("dropout", dropout_rng is not None, "training slice"),
            ("paged_decode", paged_decode, "decode"),
            ("a8_dots", a8_dots, "frozen-base quantization"),
            ("save_q8", save_q8, "frozen-base quantization"),
            ("context_parallel", context_parallel is not None, "parallelism"),
            ("host_stream", host_stream is not None, "parallelism")):
        if value:
            raise NotImplementedError(_NOT_PORTED.format(flag, item))
    if inputs_embeds is None:
        inputs_embeds = base["embed"][tokens.long()]
    h = inputs_embeds
    b, L, _ = h.shape
    dev = h.device

    if positions is None:
        positions = torch.arange(L, device=dev).expand(b, L)
    total_len = cache["length"] + L if cache is not None else L
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling, seq_len=total_len,
                            max_seq_len=cfg.max_seq_len)

    if cache is not None:
        S = kv_cache_shape(cache)[2]
        if attn_mask is None:
            raise ValueError("cached forward needs attn_mask over the cache")
        q_offset = cache["length"]
    else:
        S, q_offset = L, 0
        if attn_mask is None:
            attn_mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    if use_flash:
        bias = None
        attn_mask = attn_mask.to(torch.int32)  # once, not per layer
    else:
        bias = causal_bias(attn_mask, L, S, q_offset=q_offset)

    for i in range(cfg.n_layers):
        layer = {name: t[i] for name, t in base["layers"].items()}
        ad = None
        if adapters is not None:
            ad = {name: {"a": p["a"][i], "b": p["b"][i]}
                  for name, p in adapters["layers"].items()}
        h = _decoder_layer(cfg, spec, use_flash, use_fused_moka, h, layer,
                           ad, masks, bias, attn_mask, cos, sin, cache, i)

    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "length": cache["length"] + L}
    h = rmsnorm(h, base["final_norm"], cfg.rms_eps)
    return (head_logits(h, base["lm_head"]) if logits else h), new_cache


def head_logits(h: torch.Tensor, lm_head, a8: bool | str = False
                ) -> torch.Tensor:
    """fp32 logits = h @ lm_head (products of the stored values, fp32
    accumulation and output)."""
    if isinstance(lm_head, dict) or a8:
        raise NotImplementedError(_NOT_PORTED.format(
            "a quantized lm_head", "frozen-base quantization"))
    return torch.matmul(h.float(), lm_head.float())
