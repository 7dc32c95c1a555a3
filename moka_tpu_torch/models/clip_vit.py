"""CLIP vision tower (ViT-L/14), a frozen feature extractor (port of
``moka_tpu/models/clip_vit.py``).

Parameters keep the JAX layout (layer-stacked ``{"w": (d_in, d_out),
"b"}`` dicts, the patch embedding as a (p*p*3, h) matrix over unfolded
pixel blocks), so a JAX tree converts with ``convert.params_from_numpy``.
The layer scan becomes a loop that stops after the last selected layer:
with the reference selection (14, 23) it runs 23 of the 24 layers, whose
outputs equal JAX's (the scan's 24th output is discarded there).

``use_flash``: the (b*t, 257)-token self-attention through ``flash_mha``
(non-causal, every key valid): on the card the flash forward kernel at
head_dim 64 (``kernels/csrc/flash_fwd.cu``), once per layer that runs.
Without it, the eager attention with fp32 scores, as JAX's eager branch.
The tower is frozen: callers run it under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.models.layers import dense, layer_norm, stacked_layer
from moka_tpu_torch.ops.flash_attention import flash_mha


@dataclasses.dataclass(frozen=True)
class ClipVitConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    intermediate: int = 4096
    ln_eps: float = 1e-5
    # an int8-quantized tower: per-token int8 activations on its dense
    # products (W8A8, ``qmatmul_a8``)
    a8_dots: bool = False
    # the self-attention through the flash forward kernel
    use_flash: bool = False

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_l_14() -> "ClipVitConfig":
        return ClipVitConfig()

    @staticmethod
    def tiny() -> "ClipVitConfig":
        return ClipVitConfig(image_size=28, patch_size=14, hidden=32,
                             n_layers=2, n_heads=4, intermediate=64)


def init_clip_params(generator: torch.Generator, cfg: ClipVitConfig, *,
                     device=None, dtype=torch.float32) -> dict:
    """Random init as JAX's (normal 0.02 weights, zero biases, unit norms),
    drawn in fp32 and cast; ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    h, i, n, p = cfg.hidden, cfg.intermediate, cfg.n_layers, cfg.patch_size

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) *
                0.02).to(dtype)

    def lin(a, b):
        return {"w": normal(n, a, b),
                "b": torch.zeros((n, b), dtype=dtype, device=dev)}

    def norm(*lead):
        return {"g": torch.ones((*lead, h), dtype=dtype, device=dev),
                "b": torch.zeros((*lead, h), dtype=dtype, device=dev)}

    layers = {"ln1": norm(n), "q": lin(h, h), "k": lin(h, h),
              "v": lin(h, h), "out": lin(h, h), "ln2": norm(n),
              "fc1": lin(h, i), "fc2": lin(i, h)}
    return {"cls": normal(h), "patch": normal(p * p * 3, h),
            "pos": normal(cfg.n_patches + 1, h), "pre_ln": norm(),
            "post_ln": norm(), "layers": layers}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(b, 3, H, W) -> (b, n_patches, patch*patch*3), channel-major within
    each patch, as HF's Conv2d(k=p, s=p) weight (h, 3, p, p) flattens."""
    b, c, H, W = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # b, gh, gw, c, p, p
    return x.reshape(b, gh * gw, c * patch * patch)


def _attention(q, k, v, cfg: ClipVitConfig) -> torch.Tensor:
    """(bb, L, H, hd) -> (bb, L, H, hd), non-causal over every token."""
    bb, L, _, hd = q.shape
    if cfg.use_flash:
        ones = torch.ones((bb, L), dtype=torch.int32, device=q.device)
        return flash_mha(q, k, v, ones, causal=False)
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
    pr = torch.softmax(s / math.sqrt(hd), dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", pr.to(v.dtype), v)


def _layer(x: torch.Tensor, p: dict, cfg: ClipVitConfig) -> torch.Tensor:
    a8 = cfg.a8_dots
    y = layer_norm(x, p["ln1"], cfg.ln_eps)
    bb, L, h = y.shape
    heads = (bb, L, cfg.n_heads, h // cfg.n_heads)
    q = dense(y, p["q"], a8).reshape(heads)
    k = dense(y, p["k"], a8).reshape(heads)
    v = dense(y, p["v"], a8).reshape(heads)
    x = x + dense(_attention(q, k, v, cfg).reshape(bb, L, h), p["out"], a8)
    y = layer_norm(x, p["ln2"], cfg.ln_eps)
    return x + dense(quick_gelu(dense(y, p["fc1"], a8)), p["fc2"], a8)


def clip_hidden_states(params: dict, cfg: ClipVitConfig,
                       images: torch.Tensor,
                       select_layers: tuple[int, ...]) -> list[torch.Tensor]:
    """[hidden_states[l][:, 1:] for l in select_layers] (CLS dropped), HF's
    numbering: 0 is the embedding after ``pre_ln``, l > 0 the output of
    encoder layer l.  Runs layers 1..max(select_layers) only."""
    b = images.shape[0]
    x = torch.matmul(patchify(images, cfg.patch_size), params["patch"])
    cls = params["cls"].expand(b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1) + params["pos"]
    x = layer_norm(x, params["pre_ln"], cfg.ln_eps)
    kept = {0: x} if 0 in select_layers else {}
    for i in range(max(select_layers)):
        x = _layer(x, stacked_layer(params["layers"], i), cfg)
        if i + 1 in select_layers:
            kept[i + 1] = x
    return [kept[l][:, 1:] for l in select_layers]


def encode_video(params: dict, cfg: ClipVitConfig, video: torch.Tensor,
                 select_layers: tuple[int, ...]) -> list[torch.Tensor]:
    """(b, t, 3, H, W) -> [(b, t*n_patches, hidden)] per selected layer."""
    b, t = video.shape[:2]
    frames = video.reshape(b * t, *video.shape[2:])
    feats = clip_hidden_states(params, cfg, frames, select_layers)
    return [f.reshape(b, t * f.shape[1], f.shape[2]) for f in feats]
