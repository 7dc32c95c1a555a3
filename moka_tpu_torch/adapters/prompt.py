"""Prompt tuning and prefix tuning (port of ``moka_tpu/adapters/prompt.py``).

Each composes with the decoder without changing it:
  * prompt tuning, p-tuning and multitask prompts: learnable embeddings
    prepended to ``inputs_embeds`` (with the mask, label and position
    extensions);
  * prefix tuning: learnable per-layer key/value prefixes written into a
    KV cache (``llama.init_kv_cache``'s layout), so the decoder's cached
    attention is the injection point.  The cache's tensors then require
    grad and the cached forward writes the new k/v out of place
    (``llama._kv_update``), so gradients reach the prefixes;
  * LN tuning: only the norm scales train;
  * adaption prompts (LLaMA-Adapter): a gated attention over a learnable
    prompt added to a layer's output.

Where JAX takes a key, these take a ``torch.Generator`` (on ``device``);
the two draw different numbers, so parity tests feed both the same values.
"""

from __future__ import annotations

import math

import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.device import resolve_device

IGNORE = -100


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


# -------------------------------------------------------- prompt tuning --

def init_soft_prompt(generator: torch.Generator, cfg: LlamaConfig,
                     n_tokens: int, embed_table: torch.Tensor | None = None,
                     *, device=None) -> torch.Tensor:
    """(n_tokens, dim) fp32: rows of the vocab embedding drawn at random
    when given (PEFT's TEXT init), else normal(0.02)."""
    dev = resolve_device(device)
    if embed_table is not None:
        idx = torch.randint(0, embed_table.shape[0], (n_tokens,),
                            generator=generator, device=dev)
        return embed_table[idx.to(embed_table.device)].float().to(dev)
    return _normal(generator, (n_tokens, cfg.dim), dev) * 0.02


def _prepend(pre: torch.Tensor, inputs_embeds: torch.Tensor,
             attn_mask=None, labels=None, positions=None):
    """pre (b, n, d) before inputs_embeds, every aux tensor extended."""
    b = inputs_embeds.shape[0]
    n = pre.shape[1]
    dev = inputs_embeds.device
    embeds = torch.cat([pre.to(inputs_embeds.dtype), inputs_embeds], dim=1)
    if attn_mask is not None:
        attn_mask = torch.cat([torch.ones((b, n), dtype=attn_mask.dtype,
                                          device=dev), attn_mask], dim=1)
    if labels is not None:
        labels = torch.cat([torch.full((b, n), IGNORE, dtype=labels.dtype,
                                       device=dev), labels], dim=1)
    if positions is not None:
        positions = torch.cat(
            [torch.arange(n, dtype=positions.dtype, device=dev).expand(b, n),
             positions + n], dim=1)
    return embeds, attn_mask, labels, positions


def apply_soft_prompt(prompt: torch.Tensor, inputs_embeds: torch.Tensor,
                      attn_mask: torch.Tensor | None = None,
                      labels: torch.Tensor | None = None,
                      positions: torch.Tensor | None = None):
    """Prepend the (n, d) soft prompt to every sample; returns (embeds,
    attn_mask, labels, positions) with each given aux tensor extended
    (mask ones, labels IGNORE, positions 0..n-1 then shifted by n)."""
    b, _, d = inputs_embeds.shape
    pre = prompt[None].expand(b, *prompt.shape)
    return _prepend(pre, inputs_embeds, attn_mask, labels, positions)


# -------------------------------------------------------- prefix tuning --

def init_prefix(generator: torch.Generator, cfg: LlamaConfig, n_prefix: int,
                *, device=None) -> dict:
    """Per-layer learnable k/v prefixes (n_layers, n_prefix, kv_heads, hd),
    normal(0.02)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_prefix, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _normal(generator, shape, dev) * 0.02,
            "v": _normal(generator, shape, dev) * 0.02}


def prefix_cache(prefix: dict, cfg: LlamaConfig, batch: int, max_len: int,
                 dtype=torch.float32) -> tuple[dict, torch.Tensor]:
    """A KV cache of n_prefix + max_len positions whose first n_prefix hold
    the prefixes (differentiably: the cache requires grad where the
    prefixes do); ``length`` is the host int n_prefix.  Returns (cache,
    the (batch, n_prefix) int32 mask of the prefix slots), the mask that
    callers put before their tokens'."""
    n = prefix["k"].shape[1]
    dev = prefix["k"].device
    total = n + max_len
    shape = (cfg.n_layers, batch, total, cfg.n_kv_heads, cfg.head_dim)

    def side(p):
        pre = p[:, None].to(dtype).expand(cfg.n_layers, batch, *p.shape[1:])
        tail = torch.zeros((*shape[:2], max_len, *shape[3:]), dtype=dtype,
                           device=dev)
        return torch.cat([pre, tail], dim=2)

    cache = {"k": side(prefix["k"]), "v": side(prefix["v"]), "length": n}
    return cache, torch.ones((batch, n), dtype=torch.int32, device=dev)


# ----------------------------------------------------------- p-tuning ----

def init_ptuning_encoder(generator: torch.Generator, cfg: LlamaConfig,
                         n_tokens: int, hidden: int = 128, *,
                         device=None) -> dict:
    """P-tuning: virtual-token embeddings reparametrized by a 2-layer MLP
    prompt encoder."""
    dev = resolve_device(device)
    return {
        "virtual": _normal(generator, (n_tokens, hidden), dev) * 0.02,
        "w1": _normal(generator, (hidden, hidden), dev) * 0.02,
        "b1": torch.zeros((hidden,), device=dev),
        "w2": _normal(generator, (hidden, cfg.dim), dev) * 0.02,
        "b2": torch.zeros((cfg.dim,), device=dev),
    }


def ptuning_prompt(p: dict) -> torch.Tensor:
    """-> (n_tokens, dim) soft prompt (for ``apply_soft_prompt``)."""
    h = torch.tanh(p["virtual"] @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


# ---------------------------------------------------------- ln-tuning ----

def ln_tuning_split(base: dict) -> tuple[dict, dict]:
    """LN tuning: ONLY the norm scales train.  Returns (trainable norms,
    the base); recombine with ``ln_tuning_merge`` inside the loss."""
    trainable = {
        "attn_norm": base["layers"]["attn_norm"],
        "mlp_norm": base["layers"]["mlp_norm"],
        "final_norm": base["final_norm"],
    }
    return trainable, base


def ln_tuning_merge(trainable_norms: dict, frozen_base: dict) -> dict:
    layers = dict(frozen_base["layers"])
    layers["attn_norm"] = trainable_norms["attn_norm"]
    layers["mlp_norm"] = trainable_norms["mlp_norm"]
    out = dict(frozen_base)
    out["layers"] = layers
    out["final_norm"] = trainable_norms["final_norm"]
    return out


# -------------------------------------------- multitask prompt tuning ----

def init_multitask_prompt(generator: torch.Generator, cfg: LlamaConfig,
                          n_tokens: int, n_tasks: int,
                          embed_table: torch.Tensor | None = None, *,
                          device=None) -> dict:
    """A shared soft prompt and per-task rank-1 Hadamard factors: task t's
    prompt is ``shared * (task_cols[t] @ task_rows[t])``; the factors start
    at 1 (identity modulation)."""
    dev = resolve_device(device)
    return {
        "prompt": init_soft_prompt(generator, cfg, n_tokens, embed_table,
                                   device=dev),
        "task_cols": torch.ones((n_tasks, n_tokens, 1), device=dev),
        "task_rows": torch.ones((n_tasks, 1, cfg.dim), device=dev),
    }


def multitask_prompt(p: dict, task_ids: torch.Tensor) -> torch.Tensor:
    """(b, n_tokens, dim) per-sample prompts."""
    cols = p["task_cols"][task_ids]          # (b, n, 1)
    rows = p["task_rows"][task_ids]          # (b, 1, d)
    return p["prompt"][None] * torch.matmul(cols, rows)


def apply_multitask_prompt(p: dict, task_ids: torch.Tensor,
                           inputs_embeds: torch.Tensor,
                           attn_mask: torch.Tensor | None = None,
                           labels: torch.Tensor | None = None,
                           positions: torch.Tensor | None = None):
    """``apply_soft_prompt`` with each sample's task prompt."""
    return _prepend(multitask_prompt(p, task_ids), inputs_embeds,
                    attn_mask, labels, positions)


# ------------------------------------------------- adaption prompt -------

def init_adaption_prompt(generator: torch.Generator, cfg: LlamaConfig,
                         adapter_len: int, adapter_layers: int, *,
                         device=None) -> dict:
    """LLaMA-Adapter: per adapted layer (the top ``adapter_layers``), a
    learnable prompt of ``adapter_len`` tokens (standard normal) and a
    zero gate."""
    dev = resolve_device(device)
    return {
        "prompt": _normal(generator, (adapter_layers, adapter_len, cfg.dim),
                          dev),
        "gate": torch.zeros((adapter_layers,), device=dev),
    }


def adaption_prompt_delta(q: torch.Tensor, prompt: torch.Tensor,
                          gate: torch.Tensor, k_w: torch.Tensor,
                          v_w: torch.Tensor, o_w: torch.Tensor
                          ) -> torch.Tensor:
    """One adapted layer's additive attention output:

      k_a = prompt @ k_w; v_a = prompt @ v_w          (no RoPE: the prompt
                                                       has no position)
      out = o_proj(gate * softmax(q k_a^T / sqrt(hd)) v_a)

    q (b, L, H, hd) rotated queries; k_w/v_w (dim, K*hd); o_w (H*hd, dim);
    prompt (adapter_len, dim); gate a scalar.  The scores in fp32, the
    probabilities in q's dtype.  Returns (b, L, dim)."""
    b, L, H, hd = q.shape
    al = prompt.shape[0]
    k_a = (prompt @ k_w).reshape(al, -1, hd)        # (al, K, hd)
    v_a = (prompt @ v_w).reshape(al, -1, hd)
    G = H // k_a.shape[1]
    k_a = torch.repeat_interleave(k_a, G, dim=1)    # GQA -> (al, H, hd)
    v_a = torch.repeat_interleave(v_a, G, dim=1)
    s = torch.einsum("blhd,ahd->bhla", q.float(), k_a.float()) / \
        math.sqrt(hd)
    probs = gate * torch.softmax(s, dim=-1)
    out = torch.einsum("bhla,ahd->blhd", probs.to(q.dtype), v_a.to(q.dtype))
    return out.reshape(b, L, H * hd) @ o_w
