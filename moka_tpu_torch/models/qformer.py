"""BLIP-2 Q-Former: BERT with learnable queries and cross-attention (port
of ``moka_tpu/models/qformer.py``).

Embeddings: the queries, then (optionally) question text as word +
position embeddings, one LayerNorm over the concatenation.  Each layer:
bidirectional self-attention over [queries; text], cross-attention of the
query slice onto the encoder features, then separate FFNs for the query
and the text slices; post-LN residuals, LayerNorm eps 1e-12.  Trainable
(the projectors' backbone), fp32, layer-stacked as in JAX.  Without
question text, ``word_embed``, ``pos_embed`` and the ``ffn_t_*`` leaves
take no part in the output.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.models.layers import dense, layer_norm, stacked_layer


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden: int = 768
    n_layers: int = 2
    n_heads: int = 12
    intermediate: int = 3072
    encoder_width: int = 1408        # cross-attention key/value input dim
    vocab_size: int = 30522
    max_positions: int = 512
    ln_eps: float = 1e-12
    num_query_tokens: int = 32
    initializer_range: float = 0.02


def init_qformer_params(generator: torch.Generator, cfg: QFormerConfig, *,
                        device=None) -> dict:
    """Random fp32 init as JAX's (normal ``initializer_range``, zero
    biases, unit norms); ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    std, n = cfg.initializer_range, cfg.n_layers
    h, i, ew = cfg.hidden, cfg.intermediate, cfg.encoder_width

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev) * std

    def lin(a, b):
        return {"w": normal(n, a, b), "b": torch.zeros((n, b), device=dev)}

    def norm(*lead):
        return {"g": torch.ones((*lead, h), device=dev),
                "b": torch.zeros((*lead, h), device=dev)}

    layers = {"attn_q": lin(h, h), "attn_k": lin(h, h), "attn_v": lin(h, h),
              "attn_out": lin(h, h), "attn_ln": norm(n),
              "cross_q": lin(h, h), "cross_k": lin(ew, h),
              "cross_v": lin(ew, h), "cross_out": lin(h, h),
              "cross_ln": norm(n),
              "ffn_q_in": lin(h, i), "ffn_q_out": lin(i, h),
              "ffn_q_ln": norm(n),
              "ffn_t_in": lin(h, i), "ffn_t_out": lin(i, h),
              "ffn_t_ln": norm(n)}
    return {"word_embed": normal(cfg.vocab_size, h),
            "pos_embed": normal(cfg.max_positions, h),
            "embed_ln": norm(),
            "query_tokens": normal(cfg.num_query_tokens, h),
            "layers": layers}


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(b, S) validity -> (b, 1, 1, S) additive fp32 bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, -1e30)


def _bert_attention(x_q, x_kv, mask_bias, p_q, p_k, p_v, p_out, p_ln,
                    n_heads: int, eps: float) -> torch.Tensor:
    """Post-LN BERT attention block; ``mask_bias`` (b, 1, Lq | 1, Lk)
    additive or None."""
    b, Lq, h = x_q.shape
    hd = h // n_heads
    q = dense(x_q, p_q).reshape(b, Lq, n_heads, hd)
    k = dense(x_kv, p_k).reshape(b, -1, n_heads, hd)
    v = dense(x_kv, p_v).reshape(b, -1, n_heads, hd)
    scores = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask_bias is not None:
        scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)
    return layer_norm(dense(ctx.reshape(b, Lq, h), p_out) + x_q, p_ln, eps)


def _ffn(x, p_in, p_out, p_ln, eps):
    return layer_norm(dense(F.gelu(dense(x, p_in)), p_out) + x, p_ln, eps)


def qformer_encode(params: dict, cfg: QFormerConfig,
                   encoder_states: torch.Tensor,
                   encoder_mask: torch.Tensor | None = None,
                   text_ids: torch.Tensor | None = None,
                   text_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Queries (and optional question text) through the Q-Former over
    ``encoder_states`` (b, S, encoder_width); ``encoder_mask`` (b, S) hides
    keys of the cross-attention.  Returns the query slice of the last
    hidden state, (b, num_query_tokens, hidden)."""
    b = encoder_states.shape[0]
    nq = cfg.num_query_tokens
    x = params["query_tokens"].expand(b, nq, cfg.hidden)
    self_bias = None
    if text_ids is not None:
        Lt = text_ids.shape[1]
        text = params["word_embed"][text_ids.long()] + \
            params["pos_embed"][:Lt][None]
        x = torch.cat([x, text], dim=1)
        if text_mask is None:
            text_mask = torch.ones((b, Lt), dtype=torch.int32,
                                   device=text_ids.device)
        self_bias = _mask_bias(torch.cat(
            [torch.ones((b, nq), dtype=torch.int32, device=text_ids.device),
             text_mask.to(torch.int32)], dim=1))
    x = layer_norm(x, params["embed_ln"], cfg.ln_eps)
    cross_bias = None if encoder_mask is None else _mask_bias(encoder_mask)
    eps = cfg.ln_eps
    for i in range(cfg.n_layers):
        p = stacked_layer(params["layers"], i)
        x = _bert_attention(x, x, self_bias, p["attn_q"], p["attn_k"],
                            p["attn_v"], p["attn_out"], p["attn_ln"],
                            cfg.n_heads, eps)
        xq, xt = x[:, :nq], x[:, nq:]
        xq = _bert_attention(xq, encoder_states, cross_bias, p["cross_q"],
                             p["cross_k"], p["cross_v"], p["cross_out"],
                             p["cross_ln"], cfg.n_heads, eps)
        xq = _ffn(xq, p["ffn_q_in"], p["ffn_q_out"], p["ffn_q_ln"], eps)
        if xt.shape[1]:
            xt = _ffn(xt, p["ffn_t_in"], p["ffn_t_out"], p["ffn_t_ln"], eps)
        x = torch.cat([xq, xt], dim=1)
    return x[:, :nq]
