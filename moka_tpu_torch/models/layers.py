"""The LayerNorm and dense layers shared by the towers (CLIP ViT, BEATs),
the Q-Former and the projectors (each JAX module keeps its own copy:
``moka_tpu/models/{clip_vit,beats,qformer}.py``'s ``_ln`` and
``_dense``)."""

from __future__ import annotations

import torch

from moka_tpu_torch.ops.quant import is_quantized, qmatmul, qmatmul_a8


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 (mean, then the mean of squared deviations, as
    ``jnp.var``), scaled and shifted, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


def dense(x: torch.Tensor, p: dict, a8: bool = False) -> torch.Tensor:
    """x @ w + b.  ``p["w"]`` may be a quantized dict (``quantize_encoder``):
    with ``a8``, an int8 weight and a 3-D x, the W8A8 product
    (``qmatmul_a8``), else the weight-only one (``qmatmul``).  A plain
    weight of another dtype than x (the importers' trees: bf16 embeddings,
    fp32 layers) promotes both operands, as ``jnp.einsum`` does."""
    w = p["w"]
    if is_quantized(w):
        if a8 and "w_i8" in w and x.dim() == 3:
            return qmatmul_a8(x, w) + p["b"]
        return qmatmul(x, w) + p["b"]
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt)) + p["b"]


def stacked_layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of a layer-stacked tree (views; quantized dicts kept as
    dicts)."""
    if isinstance(layers, dict):
        return {k: stacked_layer(v, i) for k, v in layers.items()}
    return layers[i]
