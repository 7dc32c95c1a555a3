"""BEATs audio encoder, frozen: a conv patch embedding and a deep-norm
transformer with a gated relative position bias (port of
``moka_tpu/models/beats.py``).

Parameters keep the JAX layout (layer-stacked ``{"w", "b"}`` dicts, the
16x16 patch conv as a (p*p, e) matrix over unfolded fbank blocks, the
grouped positional conv's weight as (h, h/groups, k), JAX's OIH, which is
``F.conv1d``'s layout).  The relative bias table is shared by the layers;
each layer gates it by its own query.  The softmax is a plain fp32 one, as
JAX's.  The tower is frozen: callers run it under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.models.layers import dense, layer_norm, stacked_layer


@dataclasses.dataclass(frozen=True)
class BeatsConfig:
    """Defaults: the BEATs_iter3_plus_AS2M checkpoint's config."""

    input_patch_size: int = 16
    embed_dim: int = 512
    encoder_embed_dim: int = 768
    encoder_layers: int = 12
    encoder_ffn_dim: int = 3072
    encoder_heads: int = 12
    conv_bias: bool = False
    deep_norm: bool = True
    layer_norm_first: bool = False
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 1280
    gru_rel_pos: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    ln_eps: float = 1e-5
    # an int8-quantized tower: W8A8 dense products (``qmatmul_a8``)
    a8_dots: bool = False

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_heads

    @property
    def deep_norm_alpha(self) -> float:
        return (2 * self.encoder_layers) ** 0.25 if self.deep_norm else 1.0

    @staticmethod
    def tiny() -> "BeatsConfig":
        return BeatsConfig(input_patch_size=16, embed_dim=24,
                           encoder_embed_dim=48, encoder_layers=2,
                           encoder_ffn_dim=96, encoder_heads=4,
                           num_buckets=16, max_distance=64, conv_pos=16,
                           conv_pos_groups=4)


def init_beats_params(generator: torch.Generator, cfg: BeatsConfig, *,
                      device=None, dtype=torch.float32) -> dict:
    """Random init as JAX's, drawn in fp32 and cast; ``generator`` must
    live on ``device``."""
    dev = resolve_device(device)
    e, h, f, p = cfg.embed_dim, cfg.encoder_embed_dim, cfg.encoder_ffn_dim, \
        cfg.input_patch_size
    n, hd, H = cfg.encoder_layers, cfg.head_dim, cfg.encoder_heads

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=generator, device=dev) *
                std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def lin(a, b, *lead):
        return {"w": normal(*lead, a, b), "b": zeros(*lead, b)}

    def norm(width, *lead):
        return {"g": ones(*lead, width), "b": zeros(*lead, width)}

    layers = {"q": lin(h, h, n), "k": lin(h, h, n), "v": lin(h, h, n),
              "out": lin(h, h, n), "ln_attn": norm(h, n),
              "fc1": lin(h, f, n), "fc2": lin(f, h, n),
              "ln_final": norm(h, n), "grep": lin(hd, 8, n),
              "grep_a": ones(n, H)}
    return {
        "patch": normal(p * p, e),
        "patch_bias": zeros(e) if cfg.conv_bias else None,
        "frontend_ln": norm(e),
        "post_proj": lin(e, h),
        "pos_conv_w": normal(h, h // cfg.conv_pos_groups, cfg.conv_pos,
                             std=math.sqrt(4.0 / (cfg.conv_pos * h))),
        "pos_conv_b": zeros(h),
        "encoder_ln": norm(h),
        "rel_bias": normal(cfg.num_buckets, H),
        "layers": layers,
    }


def _t5_bucket_bidirectional(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5 relative-position bucketing, in fp32 in JAX's order of
    operations: log(n / max_exact) / log(max_distance / max_exact) *
    (nb - max_exact), truncated to int32."""
    nb = num_buckets // 2
    ret = (rel > 0).to(torch.int32) * nb
    n = rel.abs()
    max_exact = nb // 2
    scaled = torch.log(torch.clamp(n, min=1).float() / max_exact) / \
        math.log(max_distance / max_exact) * (nb - max_exact)
    val_large = torch.clamp(max_exact + scaled.to(torch.int32), max=nb - 1)
    return ret + torch.where(n < max_exact, n, val_large).to(torch.int32)


def relative_bias(params: dict, cfg: BeatsConfig, length: int
                  ) -> torch.Tensor:
    """(heads, L, L) bias from the shared table."""
    pos = torch.arange(length, device=params["rel_bias"].device)
    rel = pos[None, :] - pos[:, None]  # memory - context
    bucket = _t5_bucket_bidirectional(rel, cfg.num_buckets, cfg.max_distance)
    return params["rel_bias"][bucket.long()].permute(2, 0, 1)


def patchify_fbank(fbank: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, T, 128) -> (B, T//p * 128//p, p*p) in the conv's flatten order:
    token t' * n_freq_patches + f', block row-major (kt, kf)."""
    B, T, Fq = fbank.shape
    tp, fp = T // patch, Fq // patch
    x = fbank[:, : tp * patch, :].reshape(B, tp, patch, fp, patch)
    x = x.permute(0, 1, 3, 2, 4)  # B, tp, fp, kt, kf
    return x.reshape(B, tp * fp, patch * patch)


def _pos_conv(x: torch.Tensor, params: dict, cfg: BeatsConfig
              ) -> torch.Tensor:
    """Grouped conv positional embedding, SamePad trim, exact GELU.  A
    kernel of another dtype than x (the importer's tree: a bf16 kernel
    after fp32 dense layers) promotes both, as ``layers.dense`` does; the
    JAX convolution raises there."""
    w = params["pos_conv_w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = F.conv1d(x.transpose(1, 2).to(dt), w.to(dt),
                 padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    y = y + params["pos_conv_b"][None, :, None]
    if cfg.conv_pos % 2 == 0:
        y = y[:, :, :-1]  # SamePad drops the extra trailing step
    return F.gelu(y.transpose(1, 2))


def _layer(x, p, cfg: BeatsConfig, pos_bias, key_bias):
    B, L, h = x.shape
    H, hd, a8 = cfg.encoder_heads, cfg.head_dim, cfg.a8_dots

    def heads(t):
        return t.reshape(B, L, H, hd).transpose(1, 2)

    q = heads(dense(x, p["q"], a8))
    k = heads(dense(x, p["k"], a8))
    v = heads(dense(x, p["v"], a8))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / math.sqrt(hd)
    if key_bias is not None:
        s = s + key_bias
    if pos_bias is not None:
        bias = pos_bias[None]
        if cfg.gru_rel_pos:  # the query-conditioned gate
            gates = torch.sigmoid(
                dense(q, p["grep"]).reshape(B, H, L, 2, 4).sum(-1))
            gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
            gate = gate_a * (gate_b * p["grep_a"][None, :, None, None]
                             - 1.0) + 2.0
            bias = gate * bias
        s = s + bias
    pr = torch.softmax(s.float(), dim=-1)
    ctx = torch.einsum("bhqk,bhkd->bhqd", pr.to(v.dtype), v)
    ctx = ctx.transpose(1, 2).reshape(B, L, h)
    alpha = cfg.deep_norm_alpha
    x = layer_norm(x * alpha + dense(ctx, p["out"], a8), p["ln_attn"],
                   cfg.ln_eps)
    y = dense(F.gelu(dense(x, p["fc1"], a8)), p["fc2"], a8)
    return layer_norm(x * alpha + y, p["ln_final"], cfg.ln_eps)


def beats_encode(params: dict, cfg: BeatsConfig, fbank: torch.Tensor,
                 padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T, 128) normalised fbank -> (B, n_tokens, encoder_embed_dim):
    patch embedding, LN, 512 -> 768 projection, positional conv, LN, then
    the deep-norm post-LN layers.  ``padding_mask`` (B, n_tokens), 1 at a
    padded token: zeroes it and hides it as a key."""
    x = torch.matmul(patchify_fbank(fbank, cfg.input_patch_size),
                     params["patch"])
    if params.get("patch_bias") is not None:
        x = x + params["patch_bias"]
    x = layer_norm(x, params["frontend_ln"], cfg.ln_eps)
    x = dense(x, params["post_proj"])
    if padding_mask is not None:
        x = x * (1 - padding_mask.to(x.dtype))[..., None]
    x = x + _pos_conv(x, params, cfg)
    if not cfg.layer_norm_first:
        x = layer_norm(x, params["encoder_ln"], cfg.ln_eps)
    pos_bias = relative_bias(params, cfg, x.shape[1]) \
        if cfg.relative_position_embedding else None
    key_bias = None
    if padding_mask is not None:
        key_bias = torch.where(padding_mask[:, None, None, :] > 0, -1e30, 0.0)
    for i in range(cfg.encoder_layers):
        x = _layer(x, stacked_layer(params["layers"], i), cfg, pos_bias,
                   key_bias)
    return x


def encode_audio_segments(params: dict, cfg: BeatsConfig,
                          audio: torch.Tensor) -> torch.Tensor:
    """(b, t, T, 128) fbank segments -> (b, t, n, d)."""
    b, t = audio.shape[:2]
    feats = beats_encode(params, cfg, audio.reshape(b * t, *audio.shape[2:]))
    return feats.reshape(b, t, feats.shape[1], feats.shape[2])
