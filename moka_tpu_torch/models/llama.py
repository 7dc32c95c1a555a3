"""LLaMA-2 decoder with MokA adapter slots and its losses (port of
``moka_tpu/models/llama.py``).

Parameters keep the JAX layout: layer-stacked dicts (a leading
``n_layers`` axis) with ``(d_in, d_out)`` projection matrices, so a JAX tree
converts with ``convert.params_from_numpy`` and no renaming.  The layer
``scan``/``fori_loop`` becomes a Python loop that indexes the stacked
tensors.  Every one of the seven projections goes through ``_apply_proj``
(frozen matmul + MokA delta, with LoRA dropout in training).  A frozen
projection may be a quantized ``{"w_i8"|"w_i4", "scale"}`` dict
(``ops/quant.py``): weight-only, or with ``a8_dots`` the W4A8/W8A8 product;
the lm_head likewise, and ``chunked_cross_entropy(pallas_ce=True)`` runs
an int8 head through the fused lm_head + CE kernels (``ops/fused_ce.py``).

Training: ``remat`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant), which keeps the layer input and, under a named
``remat_policy``, the tensors JAX's policy keeps by tag name
(``_RematSaves``); the dropout key is split per layer and folded per
projection as in JAX, and ``core.rng.DropoutKey`` draws its bits from the
key alone, so the recompute regenerates the same masks.  ``save_q8``
rounds the named projection outputs to per-token int8 (or fp8) codes in
the forward, and the checkpoint keeps the codes.

Not ported yet (each raises ``NotImplementedError``): int8 KV caches,
``host_stream``, ``context_parallel`` and ``paged_decode`` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.ops.attention import causal_bias, mha
from moka_tpu_torch.ops.flash_attention import flash_mha
from moka_tpu_torch.ops.fused_ce import fused_ce_loss
from moka_tpu_torch.ops.moka import (MokaSpec, decode_scale, lora_delta,
                                     lora_dropout, moka_delta)
from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
from moka_tpu_torch.ops.quant import (codes_value, dequantize,
                                      fp8_roundtrip, is_quantized, qmatmul,
                                      qmatmul_a8, qmatmul_dx, q8_roundtrip)
from moka_tpu_torch.ops.rope import apply_rope, rope_cos_sin

PROJ_DIMS = {  # name -> (d_in_attr, d_out_attr)
    "q": ("dim", "q_out"), "k": ("dim", "kv_out"), "v": ("dim", "kv_out"),
    "o": ("q_out", "dim"), "gate": ("dim", "intermediate"),
    "up": ("dim", "intermediate"), "down": ("intermediate", "dim"),
}

_PROJ_INDEX = {name: i for i, name in enumerate(PROJ_DIMS)}

# projections grouped by the input they read (q/k/v: the attention norm's
# output, gate/up: the MLP norm's): MokaSpec.dropout_shared_masks folds one
# dropout key per group instead of one per projection
_PROJ_GROUP = {"q": 0, "k": 0, "v": 0, "o": 1, "gate": 2, "up": 2,
               "down": 3}

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


class _FrozenMatmul(torch.autograd.Function):
    """``x @ w`` for a frozen ``w`` (a tensor or a quantized dict, weight
    only), kept on ``ctx`` rather than saved: the product then leaves
    nothing for a checkpoint recompute to reproduce, so a recompute may
    skip it (a kept product, or the down projection, whose output no
    backward of its layer reads), and a quantized weight is never held
    dequantized."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w, ctx.dtype = w, x.dtype
        return qmatmul(x, w)

    @staticmethod
    def backward(ctx, g):
        if is_quantized(ctx.w):
            return qmatmul_dx(g, ctx.w, ctx.dtype), None
        return torch.matmul(g, ctx.w.t()), None


def _product(x: torch.Tensor, w, a8: bool | str = False) -> torch.Tensor:
    """The frozen product: plain, weight-only quantized, or with ``a8`` on
    a quantized weight and a 3-D x (as JAX) the W4A8/W8A8 product ("full":
    int8 dX products too).  Only the plain product saves its weight."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    if a8 and x.dim() == 3:
        return qmatmul_a8(x, w, bwd_a8=(a8 == "full"))
    return _FrozenMatmul.apply(x, w)


class _Kept(torch.autograd.Function):
    """In a checkpoint recompute, the stand-in for a rounded projection
    output whose codes the forward kept: the kept value, attached to x and
    the delta as the output it replaces was, so that what follows saves
    the same tensors.  The recompute's graph only collects those tensors
    and is never differentiated."""

    @staticmethod
    def forward(ctx, value, x, delta):
        return value

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a checkpoint recompute is never differentiated")


# The JAX remat policies (``moka_tpu/models/llama.py::_remat_policy``) as the
# tag names each keeps: ``proj_{name}`` a frozen projection's product,
# ``attn_out`` the attention output, ``flash_out``/``flash_lse`` the flash
# forward's residuals.  "dots" (JAX's ``dots_saveable``, every dot product)
# keeps the seven frozen products, the dots whose recompute costs; the
# adapters' rank-r products and the eager attention's rerun in the port.
_PROJ_TAGS = tuple(f"proj_{n}" for n in PROJ_DIMS)
_FLASH_TAGS = ("flash_out", "flash_lse")
REMAT_POLICIES = {
    None: (), "full": (),
    "attn": ("attn_out",),
    "qkv": ("attn_out", "proj_q", "proj_k", "proj_v"),
    "qkvod": ("attn_out", "proj_q", "proj_k", "proj_v", "proj_o",
              "proj_down"),
    "qkvod_lse": _FLASH_TAGS + ("proj_q", "proj_k", "proj_v", "proj_o",
                                "proj_down"),
    "mlp": ("attn_out", "proj_gate", "proj_up"),
    "proj": ("attn_out",) + _PROJ_TAGS,
    "proj_nokv": ("attn_out", "proj_q", "proj_o", "proj_down", "proj_gate",
                  "proj_up"),
    "proj_nokv_lse": _FLASH_TAGS + ("proj_q", "proj_o", "proj_down",
                                    "proj_gate", "proj_up"),
    "proj_noqkv": ("attn_out", "proj_o", "proj_down", "proj_gate",
                   "proj_up"),
    "proj_lse": _FLASH_TAGS + _PROJ_TAGS,
    "dots": _PROJ_TAGS,
}


def _remat_policy(name: str | None) -> frozenset:
    """The tags policy ``name`` keeps (None / "full": none, only the layer
    input)."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}")
    return frozenset(REMAT_POLICIES[name])


# The projections each named policy keeps: ``save_q8=True`` quantizes
# exactly these.
_POLICY_SAVED_PROJS = {
    "qkv": ("q", "k", "v"),
    "qkvod": ("q", "k", "v", "o", "down"),
    "qkvod_lse": ("q", "k", "v", "o", "down"),
    "mlp": ("gate", "up"),
    "proj": tuple(PROJ_DIMS),
    "proj_nokv": ("q", "o", "down", "gate", "up"),
    "proj_nokv_lse": ("q", "o", "down", "gate", "up"),
    "proj_noqkv": ("o", "down", "gate", "up"),
    "proj_lse": tuple(PROJ_DIMS),
}


def _resolve_save_q8(save_q8, remat_policy: str | None) -> tuple:
    """-> (mode, proj_names), as the JAX function: True/"fp8" take the
    policy's set (int8 / fp8-e4m3), a tuple of names selects (int8, or fp8
    with a leading "fp8")."""
    if not save_q8:
        return ("int8", ())
    if save_q8 is True:
        return ("int8", _POLICY_SAVED_PROJS.get(remat_policy, ()))
    if save_q8 == "fp8":
        return ("fp8", _POLICY_SAVED_PROJS.get(remat_policy, ()))
    names = tuple(save_q8)
    if names and names[0] == "fp8":
        return ("fp8", names[1:])
    return ("int8", names)


class _RematSaves:
    """What one layer's checkpoint keeps for its recompute, by tag name.

    ``torch.utils.checkpoint`` reruns the whole layer and has no
    ``checkpoint_name``; this object, passed to the layer, stands in for
    it.  In the forward it keeps the tagged tensors; once ``replay`` is set
    (after the checkpointed call returns), the recompute takes them instead
    of computing them: a kept projection skips its frozen product, kept
    flash residuals skip the flash forward, a kept attention output replaces
    the recomputed one.  Skipping is safe because neither skipped producer
    saves anything for the checkpoint to match (``_FrozenMatmul`` and the
    a8 product keep their weight on ctx; the flash function still saves
    the same tensors, the kept ones).  JAX's tag on a projection marks its
    output with the delta added; the port keeps the frozen product itself,
    the same bytes, and the delta reruns in both (its backward needs its
    inner values).  A projection rounded by ``save_q8`` keeps its codes
    instead (int8 codes and fp32 per-token scales, or fp8 values: JAX tags
    those), and its recompute returns their value after rerunning the
    delta.  Like JAX, which keeps only the tagged values a backward reads,
    it never keeps ``proj_down``: the recompute stops before the down
    product (``_apply_proj``), so that tensor would only hold memory."""

    def __init__(self, names: frozenset):
        self.names = names - {"proj_down"}
        self.kept: dict[str, torch.Tensor] = {}
        self.replay = False

    def product(self, name: str, x: torch.Tensor, w, a8: bool | str = False,
                keep: bool = True) -> torch.Tensor:
        """The frozen product, kept (unless ``keep`` is False: its rounded
        output's codes are kept instead) or, in the recompute, read."""
        if torch.is_tensor(w) and w.requires_grad:  # trained: saves x, reruns
            return torch.matmul(x, w)
        tag = f"proj_{name}"
        if self.replay and keep and tag in self.kept:
            return self.kept[tag].detach()
        y = _FrozenMatmul.apply(x, w) if torch.is_tensor(w) else \
            _product(x, w, a8)
        if keep and tag in self.names:
            self.kept[tag] = y.detach()
        return y

    def keeper(self, tag: str):
        """Where a rounded projection's codes go: a function that keeps
        them under ``tag``, or None when the policy keeps nothing there."""
        if tag not in self.names or self.replay:
            return None
        return lambda codes: self.kept.__setitem__(tag, codes)

    def flash_residuals(self, call: str | None = None) -> dict | None:
        """The dict ``flash_mha`` fills in the forward and reads in the
        recompute, when the policy keeps the flash residuals: the decoder
        attention's (``call`` None) or the rank attention's of projection
        ``call`` (a dict that ``moka_delta`` keys by modality).  JAX tags
        the residuals inside ``flash_mha``'s forward rule, so its policies
        keep those of every flash call in the layer."""
        if "flash_out" not in self.names:
            return None
        if call is None:
            return self.kept
        return self.kept.setdefault(f"flash_{call}", {})

    def keep(self, tag: str, t: torch.Tensor) -> torch.Tensor:
        if tag not in self.names:
            return t
        if self.replay:
            # needing grad as the tensor it stands in for did, so that what
            # follows saves the same tensors (an unfused MokA delta saves
            # its input only when that needs grad)
            return self.kept[tag].detach().requires_grad_(t.requires_grad)
        self.kept[tag] = t.detach()
        return t


def _apply_proj(name: str, x: torch.Tensor, base_w, adapters: dict | None,
                spec: MokaSpec | None, masks: MaskBundle | None,
                dropout_rng=None, fused: bool = False,
                a8: bool | str = False, save_q8: tuple = ("int8", ()),
                saves: _RematSaves | None = None) -> torch.Tensor:
    """Frozen projection ``x @ base_w`` (``_product``; ``a8``: the W4A8
    product on a quantized base) plus the adapter delta: the text adapter
    alone when masks are None (decode steps), else the MokA delta (the
    fused kernel when ``fused``).  With a layer's dropout key and a rate >
    0, LoRA dropout on the adapter input under the key folded with this
    projection's index (or its group's, with shared masks).  ``save_q8``
    (mode, names) rounds a named projection's output (as JAX, not on the
    decode path) through ``q8_roundtrip`` or ``fp8_roundtrip``.  The delta
    runs before the frozen product, so that a checkpoint recompute, which
    stops after the last tensor the backward needs, stops before the down
    projection's product (``saves``: the layer's ``_RematSaves``)."""
    delta = None
    if adapters is not None and name in adapters:
        residuals = None
        if saves is not None and spec.flash_rank_attn:
            residuals = saves.flash_residuals(name)
        delta = _adapter_delta(name, x, adapters[name], spec, masks,
                               dropout_rng, fused, residuals)
    mode, names = save_q8
    if name not in names or (delta is not None and masks is None):
        y = _product(x, base_w, a8) if saves is None else \
            saves.product(name, x, base_w, a8)
        return y if delta is None else y + delta
    tag = f"proj_{name}"
    if saves is not None and saves.replay and tag in saves.kept:
        return _Kept.apply(codes_value(saves.kept[tag], x.dtype), x, delta)
    y = _product(x, base_w, a8) if saves is None else \
        saves.product(name, x, base_w, a8, keep=False)
    out = y if delta is None else y + delta
    roundtrip = fp8_roundtrip if mode == "fp8" else q8_roundtrip
    return roundtrip(out, None if saves is None else saves.keeper(tag))


def _adapter_delta(name, x, adapter, spec, masks, dropout_rng, fused,
                   flash_residuals=None):
    a, b = adapter["a"], adapter["b"]
    if masks is None:
        return lora_delta(x, a[0], b, decode_scale(spec))
    rng = None
    if dropout_rng is not None and spec.dropout_rate > 0:
        rng = dropout_rng.fold_in(_PROJ_GROUP[name] if
                                  spec.dropout_shared_masks else
                                  _PROJ_INDEX[name])
    if fused:
        # dropout applies to the adapter's input only: outside the kernel,
        # the base matmul keeps the clean x
        x_d = x if rng is None else lora_dropout(x, rng, spec.dropout_rate)
        return moka_delta_fused(x_d, a, b, masks.modality, masks.question,
                                spec)
    return moka_delta(x, a, b, masks.modality, masks.question, spec,
                      dropout_rng=rng, flash_residuals=flash_residuals)


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
                   use_fused_moka: bool, a8_dots: bool | str, save_q8: tuple,
                   h: torch.Tensor, layer: dict,
                   adapters: dict | None, masks: MaskBundle | None,
                   bias: torch.Tensor | None, attn_mask: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, cache: dict | None,
                   layer_idx: int, dropout_rng=None,
                   saves: _RematSaves | None = None) -> torch.Tensor:
    """One decoder block; with a cache, writes this layer's k/v into it in
    place and attends over the whole cache.  ``saves``: the tensors a remat
    policy keeps for the recompute (under ``torch.utils.checkpoint``)."""
    b, L, _ = h.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def proj(name, x):
        return _apply_proj(name, x, layer[name], adapters, spec, masks,
                           dropout_rng, fused=use_fused_moka, a8=a8_dots,
                           save_q8=save_q8, saves=saves)

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
        attn = flash_mha(q, k, v, attn_mask, q_offset=q_offset,
                         residuals=None if saves is None else
                         saves.flash_residuals())
    else:
        attn = mha(q, k, v, bias)
    attn = attn.reshape(b, L, H * hd)
    if saves is not None:
        attn = saves.keep("attn_out", attn)
    h = h + proj("o", attn)

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
    use_flash: attention through ``flash_mha`` (the CUDA kernels on the
      card, forward and backward).
    use_fused_moka: MokA deltas through ``moka_delta_fused``.
    remat: recompute each layer in the backward (while gradients are
      recorded), keeping its input and what ``remat_policy`` keeps: None or
      "full" nothing else, a name of ``REMAT_POLICIES`` its tags.  Per
      layer the recompute reruns the frozen products of q, k, v, o, gate
      and up the policy does not keep (the down product's output is read by
      no backward of the layer, so the recompute stops before it, as XLA
      drops it) and, with ``use_flash``, the flash forward unless the
      policy keeps its residuals (the ``*_lse`` policies); likewise, with
      ``spec.flash_rank_attn``, the 14 rank attention forwards of AVT
      (each kept in its own slot, as JAX's policies keep every flash
      call's).
    dropout_rng: a ``core.rng.DropoutKey``; LoRA dropout on the adapter
      inputs when ``spec.dropout_rate`` > 0.
    a8_dots: on a quantized base, the projections' W4A8/W8A8 product
      (``quant.qmatmul_a8``; "full" also quantizes the dX cotangent).
    save_q8: round the projection outputs the remat policy keeps (True),
      or those named (a tuple), to per-token int8 codes (or fp8 with
      "fp8" / a leading "fp8"), straight-through; the checkpoint keeps the
      codes (``_resolve_save_q8``).
    Returns (fp32 logits, or the final-normed hidden state when
    ``logits=False``; the new cache or None).
    """
    kept = _remat_policy(remat_policy) if remat else frozenset()
    for flag, value, item in (
            ("paged_decode", paged_decode, "decode"),
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

    layer_rngs = dropout_rng.split(cfg.n_layers) \
        if dropout_rng is not None else [None] * cfg.n_layers
    recompute = remat and torch.is_grad_enabled()
    q8 = _resolve_save_q8(save_q8, remat_policy)
    for i in range(cfg.n_layers):
        layer = {name: ({k: v[i] for k, v in t.items()}
                        if isinstance(t, dict) else t[i])
                 for name, t in base["layers"].items()}
        ad = None
        if adapters is not None:
            ad = {name: {"a": p["a"][i], "b": p["b"][i]}
                  for name, p in adapters["layers"].items()}
        args = (cfg, spec, use_flash, use_fused_moka, a8_dots, q8, h, layer,
                ad, masks, bias, attn_mask, cos, sin, cache, i,
                layer_rngs[i])
        if recompute:  # keeps h and the policy's tags; reruns the rest
            saves = _RematSaves(kept)
            h = checkpoint(_decoder_layer, *args, saves, use_reentrant=False)
            saves.replay = True
        else:
            h = _decoder_layer(*args)

    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "length": cache["length"] + L}
    h = rmsnorm(h, base["final_norm"], cfg.rms_eps)
    return (head_logits(h, base["lm_head"]) if logits else h), new_cache


def head_logits(h: torch.Tensor, lm_head, a8: bool | str = False
                ) -> torch.Tensor:
    """fp32 logits = h @ lm_head (products of the stored values, fp32
    accumulation and output).  A quantized head dequantizes to h's dtype
    first, or with ``a8`` runs the W8A8/W4A8 product straight to fp32
    (``qmatmul_a8``; "full" also quantizes the cotangent); ``a8`` leaves a
    plain head as it is, as in JAX."""
    if is_quantized(lm_head):
        if a8:
            return qmatmul_a8(h, lm_head, bwd_a8=(a8 == "full"),
                              out_dtype=torch.float32)
        lm_head = dequantize(lm_head, dtype=h.dtype)
    return torch.matmul(h.float(), lm_head.float())


def _masked_nll_sum(logits: torch.Tensor, targets: torch.Tensor,
                    ignore_index: int) -> torch.Tensor:
    """Sum of -log softmax(logits)[target] over the targets that are not
    ``ignore_index``."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, nll.new_zeros(())).sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Shift-by-one CE over the supervised positions: the mean over
    targets ``labels[:, 1:]`` that are not ``ignore_index``."""
    targets = labels[:, 1:]
    count = torch.clamp((targets != ignore_index).sum(), min=1)
    return _masked_nll_sum(logits[:, :-1], targets, ignore_index) / count


def _chunk_nll(h: torch.Tensor, lm_head, targets: torch.Tensor,
               ignore_index: int, a8: bool | str) -> torch.Tensor:
    return _masked_nll_sum(head_logits(h, lm_head, a8), targets,
                           ignore_index)


def chunked_cross_entropy(h: torch.Tensor, lm_head, labels: torch.Tensor,
                          ignore_index: int = -100, chunk: int = 128,
                          a8: bool | str = False, pallas_ce: bool = False,
                          rows_layout: bool = False) -> torch.Tensor:
    """``cross_entropy_loss(head_logits(h, lm_head), labels)`` without the
    full (b, L, V) fp32 logits: the lm_head product and the CE run over
    chunks, each recomputed in the backward (``torch.utils.checkpoint``,
    as ``jax.checkpoint`` on the JAX scan body).

    Default layout: ``chunk`` positions of every sequence at a time
    (h[:, :-1] against labels[:, 1:]).  ``rows_layout``: ``chunk`` rows of
    the flattened (b*L, d) hidden state at a time, the shift done in the
    labels (each row's last target is ignored).  The last chunk may be
    shorter; the JAX package pads it with ignored targets, which add 0.
    A quantized head and ``a8`` go to ``head_logits``.  ``pallas_ce``
    (an int8 head only, either layout) runs every row at once through
    ``fused_ce_loss``: kernels 8-9 on the card, no logits in memory."""
    b, L, d = h.shape
    if pallas_ce:
        if not (is_quantized(lm_head) and "w_i8" in lm_head):
            raise ValueError("pallas_ce requires an int8-quantized lm_head")
        return fused_ce_loss(h[:, :-1].reshape(b * (L - 1), d), lm_head,
                             labels[:, 1:].reshape(b * (L - 1)),
                             ignore_index=ignore_index)
    if rows_layout:
        ignored = torch.full((b, 1), ignore_index, dtype=labels.dtype,
                             device=labels.device)
        targets = torch.cat([labels[:, 1:], ignored], dim=1).reshape(b * L)
        rows = h.reshape(b * L, d)
        pieces = [(rows[i:i + chunk], targets[i:i + chunk])
                  for i in range(0, b * L, chunk)]
    else:
        targets, hs = labels[:, 1:], h[:, :-1]
        pieces = [(hs[:, i:i + chunk], targets[:, i:i + chunk])
                  for i in range(0, L - 1, chunk)]
    recompute = torch.is_grad_enabled()
    loss_sum = h.new_zeros((), dtype=torch.float32)
    for hc, tc in pieces:
        if recompute:
            part = checkpoint(_chunk_nll, hc, lm_head, tc, ignore_index, a8,
                              use_reentrant=False)
        else:
            part = _chunk_nll(hc, lm_head, tc, ignore_index, a8)
        loss_sum = loss_sum + part
    count = torch.clamp((targets != ignore_index).sum(), min=1)
    return loss_sum / count
