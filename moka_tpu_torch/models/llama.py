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

Serving: the KV cache is bf16 (or the model's dtype) or int8 with fp32
per-(token, head) scales (``init_kv_cache(quantized=True)``); a decode
step with ``paged_decode`` attends through ``ops/paged_decode.py`` (a CUDA
kernel on the card) over the valid cache prefix only.

Parallelism (``parallel/``): a base whose leaves are fsdp-sharded
(``sharding.shard_params``) or in pinned host memory (``host_stream``) is
fetched a layer at a time inside the remat region (``parallel.stream``),
so the recompute fetches it again; ``context_parallel=(mesh, axis)`` runs
each rank's sequence shard with attention through a k/v ring
(``parallel.ring_attention``) and MokA's rank attention over the question
keys of every shard.  A base whose projections ``shard_params`` split over
a ``model`` axis runs tensor-parallel (``parallel.tensor``): each rank
computes its H/m query heads (and K/m kv heads, or all of them where K % m
!= 0) with column-parallel q/k/v/gate/up and row-parallel o/down, whose
outputs are summed over the model group.
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
from moka_tpu_torch.ops.paged_decode import paged_decode_attention
from moka_tpu_torch.ops.quant import (codes_value, dequantize,
                                      fp8_roundtrip, is_quantized, qmatmul,
                                      qmatmul_a8, qmatmul_dx, q8_roundtrip)
from moka_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from moka_tpu_torch.parallel import tensor as tp
from moka_tpu_torch.parallel.stream import (LayerRef, LayerStream,
                                            elsewhere, fetch, needs_fetch)

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

    modality: (M, b, L) 0/1 with index 0 the text; question: (b, L) 0/1.
    Under context parallelism (set by ``forward``): ``key_question`` the
    question mask of the whole sequence, and ``gather_keys`` the
    differentiable all-gather of a (b, L_shard, r) shard of question keys
    over the sequence group."""
    modality: torch.Tensor
    question: torch.Tensor
    key_question: torch.Tensor | None = None
    gather_keys: object = None


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


def _product(x: torch.Tensor, w, a8: bool | str = False,
             split: tp.ModelSplit | None = None, layout: str | None = None
             ) -> torch.Tensor:
    """The frozen product: plain, weight-only quantized, or with ``a8`` on
    a quantized weight and a 3-D x (as JAX) the W4A8/W8A8 product ("full":
    int8 dX products too).  Only the plain product saves its weight.
    Under tensor parallelism (``split``), a "row" ``layout`` sums the
    rank's partial product over the model group (``tensor.row_matmul``)
    and a "column" one takes the cotangent's a8 scale over the whole
    row."""
    if layout == "row":
        return tp.row_matmul(x, w, split, a8)
    if not is_quantized(w):
        return torch.matmul(x, w)
    if a8 and x.dim() == 3:
        return qmatmul_a8(x, w, bwd_a8=(a8 == "full"),
                          group=split.group if layout == "column" else None)
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
                keep: bool = True, split=None, layout=None) -> torch.Tensor:
        """The frozen product, kept (unless ``keep`` is False: its rounded
        output's codes are kept instead) or, in the recompute, read (every
        rank of a model group skips the same products, so their
        collectives stay in step)."""
        if torch.is_tensor(w) and w.requires_grad:  # trained: saves x, reruns
            return torch.matmul(x, w)
        tag = f"proj_{name}"
        if self.replay and keep and tag in self.kept:
            return self.kept[tag].detach()
        y = _FrozenMatmul.apply(x, w) if torch.is_tensor(w) and \
            layout != "row" else _product(x, w, a8, split, layout)
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
                saves: _RematSaves | None = None,
                split: tp.ModelSplit | None = None) -> torch.Tensor:
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
    projection's product (``saves``: the layer's ``_RematSaves``).
    ``split``: the rank's part of a tensor-parallel layer (``ModelSplit``:
    this projection's layout, ``parallel.tensor``)."""
    layout = None if split is None else split.layout(name)
    delta = None
    if adapters is not None and name in adapters:
        residuals = None
        if saves is not None and spec.flash_rank_attn:
            residuals = saves.flash_residuals(name)
        delta = _adapter_delta(name, x, adapters[name], spec, masks,
                               dropout_rng, fused, residuals, split)
    mode, names = save_q8
    if name not in names or (delta is not None and masks is None):
        y = _product(x, base_w, a8, split, layout) if saves is None else \
            saves.product(name, x, base_w, a8, split=split, layout=layout)
        return y if delta is None else y + delta
    tag = f"proj_{name}"
    if saves is not None and saves.replay and tag in saves.kept:
        return _Kept.apply(codes_value(saves.kept[tag], x.dtype), x, delta)
    y = _product(x, base_w, a8, split, layout) if saves is None else \
        saves.product(name, x, base_w, a8, keep=False, split=split,
                      layout=layout)
    out = y if delta is None else y + delta
    roundtrip = fp8_roundtrip if mode == "fp8" else q8_roundtrip
    keep = None if saves is None else saves.keeper(tag)
    if layout != "column":
        return roundtrip(out, keep)
    # a column-parallel output holds the rank's columns of each token: its
    # int8 scale is the whole row's
    return roundtrip(out, keep, split.group)


def _adapter_delta(name, x, adapter, spec, masks, dropout_rng, fused,
                   flash_residuals=None, split=None):
    """The adapter delta of projection ``name``.  Under tensor parallelism
    (``split``) a column-parallel projection takes B's columns of the rank,
    and a row-parallel one A's rows (x holds those columns; the dropout key
    draws their masks) with the partial A products summed over the model
    group; the fused MokA kernel cannot run that sum, so a row-parallel
    projection takes the unfused delta (its dropout drawn as the fused
    route draws it, on x itself)."""
    a, b = adapter["a"], adapter["b"]
    layout = None if split is None else split.layout(name)
    add = None
    if layout == "row":
        c0, n = split.part(a.shape[1])
        a, add = a.narrow(1, c0, n), tp.sum_a(split)
        if dropout_rng is not None and spec.dropout_rate > 0:
            if not hasattr(dropout_rng, "cols"):
                raise ValueError("a row-parallel projection's dropout needs "
                                 "a key with a column view "
                                 "(core.rng.DropoutKey)")
            dropout_rng = dropout_rng.cols(c0, a.shape[1] * split.size)
    elif layout == "column":
        c0, n = split.part(b.shape[1])
        b = b.narrow(1, c0, n)
    if masks is None:
        return lora_delta(x, a[0], b, decode_scale(spec), sum_a=add)
    rng = None
    if dropout_rng is not None and spec.dropout_rate > 0:
        rng = dropout_rng.fold_in(_PROJ_GROUP[name] if
                                  spec.dropout_shared_masks else
                                  _PROJ_INDEX[name])
    if fused and layout != "row":
        # dropout applies to the adapter's input only: outside the kernel,
        # the base matmul keeps the clean x; under a ring the kernel attends
        # to every shard's question keys (``gather_keys``)
        x_d = x if rng is None else lora_dropout(x, rng, spec.dropout_rate)
        return moka_delta_fused(x_d, a, b, masks.modality, masks.question,
                                spec, key_question=masks.key_question,
                                gather_keys=masks.gather_keys)
    if fused:  # the fused route's dropout: lora_dropout on x
        spec = dataclasses.replace(spec, fused_dropout=False)
    return moka_delta(x, a, b, masks.modality, masks.question, spec,
                      dropout_rng=rng, flash_residuals=flash_residuals,
                      key_question=masks.key_question,
                      gather_keys=masks.gather_keys, sum_a=add)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, quantized: bool = False, *,
                  device=None) -> dict:
    """Zeroed (n_layers, batch, max_len, n_kv_heads, head_dim) k/v caches;
    ``length`` is a host int (the next write position).  ``quantized``
    stores each side int8 with fp32 per-(token, head) scales, ``{"q": int8
    zeros, "s": fp32 ones (..., 1)}``: half the bytes a decode step
    reads."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        def side():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                    device=dev)}
        return {"k": side(), "v": side(), "length": 0}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": 0}


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over head_dim: (..., hd) -> (int8
    codes, fp32 scale (..., 1)), JAX's arithmetic: scale max|x| / 127 (1
    for an all-zero row, which then quantizes exactly), codes rounded half
    to even and clipped to +-127."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(ax == 0, torch.ones_like(ax), ax / 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def _kv_update(side, new: torch.Tensor, layer_idx: int, pos: int):
    """Write ``new`` (b, L, K, hd) into layer ``layer_idx`` of one cache
    side at positions [pos, pos + L) and return the side.  An int8 side
    quantizes ``new`` (``_kv_quantize``) and writes both leaves in place.
    A plain side is written in place too, unless autograd records the
    write (a cache built from learnable prefixes, or k/v that depend on
    them): then out of place, so that the tensors earlier layers saved
    for the backward stay as they were and the gradient reaches the
    cache."""
    end = pos + new.shape[1]
    if isinstance(side, dict):
        q, s = _kv_quantize(new)
        side["q"][layer_idx, :, pos:end] = q
        side["s"][layer_idx, :, pos:end] = s
        return side
    new = new.to(side.dtype)
    if torch.is_grad_enabled() and (side.requires_grad or
                                    new.requires_grad):
        layer = side[layer_idx].slice_scatter(new, dim=1, start=pos,
                                              end=end)
        return side.select_scatter(layer, 0, layer_idx)
    side[layer_idx, :, pos:end] = new
    return side


def _kv_layer(side, layer_idx: int, dtype: torch.dtype) -> torch.Tensor:
    """One layer's (b, S, K, hd) slice in ``dtype``; an int8 side
    dequantizes as JAX does: ``(codes.float() * scale).to(dtype)``."""
    if isinstance(side, dict):
        return (side["q"][layer_idx].float() * side["s"][layer_idx]).to(dtype)
    return side[layer_idx].to(dtype)


def kv_cache_shape(cache: dict) -> tuple:
    """(n_layers, batch, S, K, hd) for plain or int8 caches."""
    k = cache["k"]
    return tuple((k["q"] if isinstance(k, dict) else k).shape)


def _decoder_layer(cfg: LlamaConfig, spec: MokaSpec | None, use_flash: bool,
                   use_fused_moka: bool, paged_decode: bool,
                   a8_dots: bool | str, save_q8: tuple,
                   h: torch.Tensor, layer: dict,
                   adapters: dict | None, masks: MaskBundle | None,
                   bias: torch.Tensor | None, attn_mask: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, cache: dict | None,
                   layer_idx: int, dropout_rng=None,
                   saves: _RematSaves | None = None,
                   ring=None, split: tp.ModelSplit | None = None
                   ) -> torch.Tensor:
    """One decoder block; with a cache, writes this layer's k/v into it
    (``_kv_update``: ``cache["k"]``/``["v"]`` are replaced by what it
    returns) and attends over the whole cache, dequantized for an int8 one
    as JAX does, or, for a single token with ``paged_decode``, through
    ``paged_decode_attention`` over the valid prefix.  ``saves``: the
    tensors a remat policy keeps for the recompute (under
    ``torch.utils.checkpoint``).  ``layer`` may be a ``LayerRef``: the
    weights are fetched here, inside the remat region.  ``ring``: the
    context-parallel attention over this rank's sequence shard.
    ``split``: the rank's part of a tensor-parallel layer: H/m query heads
    and K/m kv heads (or the kv heads of its query heads, from k and v
    whole), each block's input through ``tensor.enter``."""
    b, L, _ = h.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kv_sel = None
    if split is not None:
        H = H // split.size
        if split.kv_whole:
            kv_sel = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads, split)
        else:
            K = K // split.size
    if isinstance(layer, LayerRef):
        layer = layer.get()

    def proj(name, x):
        return _apply_proj(name, x, layer[name], adapters, spec, masks,
                           dropout_rng, fused=use_fused_moka, a8=a8_dots,
                           save_q8=save_q8, saves=saves, split=split)

    def heads(t):  # (b, L, K, hd) -> this rank's kv heads
        if kv_sel is None:
            return t
        if isinstance(kv_sel, slice):
            return t[:, :, kv_sel]
        return t.index_select(2, kv_sel.to(t.device))

    x = rmsnorm(h, layer["attn_norm"], cfg.rms_eps)
    if split is not None:
        x = tp.enter(x, split)
    q = apply_rope(proj("q", x).reshape(b, L, H, hd), cos, sin)
    k = apply_rope(heads(proj("k", x).reshape(b, L, K, hd)), cos, sin)
    v = heads(proj("v", x).reshape(b, L, K, hd))

    paged = cache is not None and paged_decode and L == 1
    q_offset = 0
    if cache is not None:
        q_offset = cache["length"]
        cache["k"] = _kv_update(cache["k"], k, layer_idx, q_offset)
        cache["v"] = _kv_update(cache["v"], v, layer_idx, q_offset)
        if not paged:
            k = _kv_layer(cache["k"], layer_idx, q.dtype)
            v = _kv_layer(cache["v"], layer_idx, q.dtype)

    if paged:
        attn = paged_decode_attention(q, cache["k"], cache["v"], attn_mask,
                                      layer_idx, q_offset + 1)
    elif ring is not None:
        attn = ring(q, k.to(q.dtype), v.to(q.dtype), attn_mask)
    elif use_flash:
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
    if split is not None:
        x = tp.enter(x, split)
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
    cache: from ``init_kv_cache`` (plain or int8).  The cached forward
      writes the new k/v into ``cache["k"]``/``cache["v"]`` IN PLACE at
      [length, length + L) and returns a new dict holding the same tensors
      with ``length`` advanced; the caller's dict is not modified
      otherwise.  Where autograd records the write (a cache built from
      learnable prefixes, ``adapters/prompt.py::prefix_cache``), the
      write is out of place and the returned dict holds the new tensors.
    paged_decode: a single-token cached step attends through
      ``ops.paged_decode.paged_decode_attention`` (the CUDA decode kernel
      on the card) over the cache's valid prefix; longer calls ignore it,
      as in JAX.
    use_flash: attention through ``flash_mha`` (the CUDA kernels on the
      card, forward and backward).
    use_fused_moka: MokA deltas through ``moka_delta_fused`` (under tensor
      parallelism the column-parallel projections hand it B's local
      columns; o and down take the unfused delta, whose partial A products
      are summed over the model group, which the kernel cannot do).
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
    context_parallel: (mesh, axis): the inputs are this rank's shard of
      the sequence split over mesh axis ``axis`` (shard ``idx`` holds
      global positions [idx * L, (idx + 1) * L); default ``positions``
      follow them), attention runs through the k/v ring
      (``parallel.ring_attention``: the flash ring with ``use_flash``), the
      rank attention's question keys are all-gathered over the group, and
      a ``DropoutKey`` draws the global rows' masks.  Training and prefill
      only (no cache), as in JAX.
    host_stream: ``parallel.sharding.stream_shardings(mesh, base)`` when
      the base is in pinned host memory (``shard_params(...,
      host_offload=True)``): each layer is copied to the compute device
      inside the remat region (``parallel.stream.LayerStream``), the
      embedding table, final norm and lm_head per use.  A base whose leaves
      are fsdp-sharded is all-gathered the same way with or without it.
    A base split over a ``model`` axis (``shard_params`` on a mesh whose
      model size is above 1) runs tensor-parallel (``parallel.tensor``):
      every rank of a model group passes the same batch and gets the same
      output.  Training and prefill only: a cached forward raises (no
      entry point serves under a mesh).
    Returns (fp32 logits, or the final-normed hidden state when
    ``logits=False``; the new cache or None).
    """
    kept = _remat_policy(remat_policy) if remat else frozenset()
    if context_parallel is not None and cache is not None:
        raise ValueError("context_parallel is a training/prefill path; "
                         "cached decode is not sequence-sharded")
    split = tp.model_split(base["layers"], cfg)
    if split is not None and cache is not None:
        raise ValueError("a base split over the model axis trains and "
                         "prefills only: decode with a KV cache under tensor "
                         "parallelism is not supported (no entry point "
                         "serves under a mesh)")
    if split is not None and context_parallel is not None:
        raise ValueError("context parallelism and a model axis do not "
                         "combine")
    dev = (tokens if inputs_embeds is None else inputs_embeds).device
    if host_stream is None and elsewhere(base["layers"], dev):
        raise ValueError("the base is not on the compute device: pass "
                         "host_stream=parallel.sharding.stream_shardings"
                         "(mesh, base) to stream it per layer")
    if inputs_embeds is None:
        inputs_embeds = fetch(base["embed"], dev)[tokens.long()]
    h = inputs_embeds
    b, L, _ = h.shape

    ring, total_len, start = None, L, 0
    if context_parallel is not None:
        from moka_tpu_torch.parallel import comm
        from moka_tpu_torch.parallel.ring_attention import (
            make_ring_attention, make_ring_flash_attention)
        cp_mesh, cp_axis = context_parallel
        group = cp_mesh.get_group(cp_axis)
        n_shards = comm.group_size(group)
        start = cp_mesh.get_local_rank(cp_axis) * L
        total_len = L * n_shards  # dynamic-NTK scales by the global length
        ring = (make_ring_flash_attention if use_flash
                else make_ring_attention)(cp_mesh, cp_axis)
        if masks is not None:
            masks = dataclasses.replace(
                masks, key_question=comm.all_gather(
                    masks.question.detach(), group, dim=1),
                gather_keys=lambda t: comm.gather_seq(t, group, dim=1))
        if dropout_rng is not None and hasattr(dropout_rng, "rows"):
            # the masks of the global rows, as one process draws them
            dropout_rng = dropout_rng.rows(1, start, total_len)
    if positions is None:
        positions = (start + torch.arange(L, device=dev)).expand(b, L)
    if cache is not None:
        total_len = cache["length"] + L
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling, seq_len=total_len,
                            max_seq_len=cfg.max_seq_len)

    paged = cache is not None and paged_decode and L == 1
    if cache is not None:
        S = kv_cache_shape(cache)[2]
        if attn_mask is None:
            raise ValueError("cached forward needs attn_mask over the cache")
        q_offset = cache["length"]
        cache = dict(cache)  # layers replace its sides (_kv_update)
    else:
        S, q_offset = L, 0
        if attn_mask is None:
            attn_mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    if use_flash or paged or ring is not None:
        bias = None
        if use_flash:
            attn_mask = attn_mask.to(torch.int32)  # once, not per layer
        elif paged and attn_mask.dtype not in (torch.int32, torch.float32):
            # the decode kernel reads int32 or fp32 masks
            attn_mask = attn_mask.to(torch.float32 if
                                     attn_mask.is_floating_point() else
                                     torch.int32)
    else:
        bias = causal_bias(attn_mask, L, S, q_offset=q_offset)

    layer_rngs = dropout_rng.split(cfg.n_layers) \
        if dropout_rng is not None else [None] * cfg.n_layers
    recompute = remat and torch.is_grad_enabled()
    stream = None
    whole = () if split is None else split.whole_leaves()
    if host_stream is not None or needs_fetch(base["layers"], dev, whole):
        stream = LayerStream(base["layers"], dev, cfg.n_layers, recompute,
                             whole)
    q8 = _resolve_save_q8(save_q8, remat_policy)
    for i in range(cfg.n_layers):
        if stream is not None:
            layer = stream.ref(i)
        else:
            layer = {name: ({k: v[i] for k, v in t.items()}
                            if isinstance(t, dict) else t[i])
                     for name, t in base["layers"].items()}
        ad = None
        if adapters is not None:
            ad = {name: {"a": p["a"][i], "b": p["b"][i]}
                  for name, p in adapters["layers"].items()}
        args = (cfg, spec, use_flash, use_fused_moka, paged_decode, a8_dots,
                q8, h, layer, ad, masks, bias, attn_mask, cos, sin, cache, i,
                layer_rngs[i])
        if recompute:  # keeps h and the policy's tags; reruns the rest
            saves = _RematSaves(kept)
            h = checkpoint(_decoder_layer, *args, saves=saves, ring=ring,
                           split=split, use_reentrant=False)
            saves.replay = True
        else:
            h = _decoder_layer(*args, ring=ring, split=split)
        if stream is not None:
            stream.after_forward(i, h)

    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "length": cache["length"] + L}
    h = rmsnorm(h, fetch(base["final_norm"], dev), cfg.rms_eps)
    if not logits:
        return h, new_cache
    return head_logits(h, fetch(base["lm_head"], dev)), new_cache


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
                       ignore_index: int = -100, shifted: bool = False,
                       count: torch.Tensor | None = None) -> torch.Tensor:
    """Shift-by-one CE over the supervised positions: the mean over
    targets ``labels[:, 1:]`` that are not ``ignore_index``.  ``shifted``:
    ``labels`` are already each position's target (a shard of a sequence
    whose shift was done whole); ``count``: divide by it instead (the
    targets of a whole batch or sequence split over ranks)."""
    if shifted:
        targets = labels
    else:
        targets, logits = labels[:, 1:], logits[:, :-1]
    if count is None:
        count = torch.clamp((targets != ignore_index).sum(), min=1)
    return _masked_nll_sum(logits, targets, ignore_index) / count


def _chunk_nll(h: torch.Tensor, lm_head, targets: torch.Tensor,
               ignore_index: int, a8: bool | str) -> torch.Tensor:
    return _masked_nll_sum(head_logits(h, lm_head, a8), targets,
                           ignore_index)


def chunked_cross_entropy(h: torch.Tensor, lm_head, labels: torch.Tensor,
                          ignore_index: int = -100, chunk: int = 128,
                          a8: bool | str = False, pallas_ce: bool = False,
                          rows_layout: bool = False, shifted: bool = False,
                          count: torch.Tensor | None = None
                          ) -> torch.Tensor:
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
    ``fused_ce_loss``: kernels 8-9 on the card, no logits in memory.
    ``shifted`` and ``count`` as ``cross_entropy_loss``'s (with
    ``shifted``, every row of h against its own target, in rows)."""
    b, L, d = h.shape
    if pallas_ce:
        if not (is_quantized(lm_head) and "w_i8" in lm_head):
            raise ValueError("pallas_ce requires an int8-quantized lm_head")
        rows, t = ((h.reshape(b * L, d), labels.reshape(b * L)) if shifted
                   else (h[:, :-1].reshape(b * (L - 1), d),
                         labels[:, 1:].reshape(b * (L - 1))))
        loss = fused_ce_loss(rows, lm_head, t, ignore_index=ignore_index)
        if count is None:
            return loss
        # the kernels give the mean over this call's targets
        local = torch.clamp((t != ignore_index).sum(), min=1)
        return loss * (local / count).to(loss.dtype)
    if shifted:
        targets = labels.reshape(b * L)
        rows = h.reshape(b * L, d)
        pieces = [(rows[i:i + chunk], targets[i:i + chunk])
                  for i in range(0, b * L, chunk)]
    elif rows_layout:
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
    if count is None:
        count = torch.clamp((targets != ignore_index).sum(), min=1)
    return loss_sum / count
