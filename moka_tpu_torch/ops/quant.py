"""Weight-only and W4A8/W8A8 quantization of the frozen base (port of
``moka_tpu/ops/quant.py``).

Layouts, as the JAX package stores them, so a JAX tree converts with no
renaming: ``{"w_i8": int8 (..., d_in, d_out), "scale": fp32 (..., 1,
d_out)}`` (symmetric per output channel, amax/127) and ``{"w_i4": uint8
(..., d_in/2, d_out), "scale"}`` (amax/7, two values a byte: the low nibble
holds rows [0, h), the high nibble rows [h, 2h)).

Products:
- ``qmatmul`` (weight-only): int8 dequantizes to x's dtype first; int4
  multiplies by the small integers with an fp32 result (a bf16 product
  with fp32 output on the card, ``torch.mm(..., out_dtype=torch.float32)``;
  the same products in fp32 on the CPU, where they are exact), scales it in
  fp32 and rounds to x's dtype once, as JAX.
- ``qmatmul_a8``: per-token int8 activations times the integer weight,
  int8 x int8 -> int32 through ``torch._int_mm`` (cuBLASLt on the card), as
  XLA's int8 einsum.  int4 unpacks both nibble halves into one int8 matrix:
  int32 sums are exact, so one product equals JAX's two half products.
  Its backward is the straight-through dX, in bf16 or (``bwd_a8``) int8.
- ``q8_roundtrip`` / ``fp8_roundtrip``: the save-set rounding of
  ``save_q8`` with a straight-through gradient.

Under tensor parallelism (``parallel.tensor``) a per-token scale is taken
over the whole row, as one process takes it, where the row is split over
the model group: ``group`` all-reduces the per-token max (the a8 codes of
a row-parallel input, the cotangent of a column-parallel output under
``bwd_a8``, the save set of a column-parallel output).

Rounding keeps JAX's order of operations (``amax / 127``, then ``x /
scale``, round half to even, clip; ``(acc * sx) * sw`` in fp32), so codes
and a8 outputs from the same fp32 inputs match bit for bit.
"""

from __future__ import annotations

import weakref

import torch

from moka_tpu_torch.parallel import comm

QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down")

FP8_TIE = 464.0  # |y| above this rounds past e4m3fn's 448: NaN, as in JAX


def _sym_quantize(w: torch.Tensor, axis: int, qmax: int):
    wf = w.float()
    a_max = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(a_max == 0, torch.ones_like(a_max), a_max / qmax)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_int8(w: torch.Tensor, axis: int = -2) -> dict:
    """Symmetric per-output-channel int8 (reduction over ``axis``, d_in)."""
    q, scale = _sym_quantize(w, axis, 127)
    return {"w_i8": q, "scale": scale}


def quantize_int4(w: torch.Tensor, axis: int = -2) -> dict:
    """Symmetric per-output-channel int4 in [-7, 7], nibble-packed along
    the input dim: rows [0, h) in the low nibble, [h, 2h) in the high."""
    if axis not in (-2, w.dim() - 2):
        raise ValueError("int4 packs along the input (contraction) dim")
    d_in = w.shape[-2]
    if d_in % 2:
        raise ValueError(f"input dim {d_in} must be even for nibble packing")
    q, scale = _sym_quantize(w, -2, 7)
    return {"w_i4": pack_int4(q), "scale": scale}


def pack_int4(q: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """int8 values in [-8, 7] (an even length along ``dim``) two a byte:
    the first half of ``dim`` in the low nibbles, the second in the
    high."""
    h = q.shape[dim] // 2
    lo, hi = q.narrow(dim, 0, h), q.narrow(dim, h, h)
    return ((lo & 0x0F) | (hi << 4)).view(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (lo, hi) int8 halves, each the size of ``packed``."""
    pi = packed.view(torch.int8)
    return (pi << 4) >> 4, pi >> 4  # arithmetic shifts sign-extend


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("w_i8" in w or "w_i4" in w)


def int_weight(w: dict) -> torch.Tensor:
    """The (..., d_in, d_out) int8 integers of a quantized weight."""
    if "w_i4" in w:
        return torch.cat(unpack_int4(w["w_i4"]), dim=-2)
    return w["w_i8"]


def dequantize(qw: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (int_weight(qw).float() * qw["scale"]).to(dtype)


def _out_scale(w: dict, ndim: int) -> torch.Tensor:
    """The per-output-channel scale shaped to broadcast over an output of
    ``ndim`` dims."""
    return w["scale"].reshape((1,) * (ndim - 1) + (-1,))


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with an fp32 result and no rounding to x's
    dtype between: on the card a half-precision product with fp32 output
    (cuBLAS, fp32 accumulation), on the CPU the same products in fp32."""
    if x.dtype == torch.float32 or x.device.type != "cuda":
        return torch.matmul(x.float(), w.float())
    out = torch.mm(x.reshape(-1, x.shape[-1]), w.to(x.dtype),
                   out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain, int8 or int4-packed weight, in x's dtype."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    if "w_i4" in w:
        acc = _matmul_f32(x, int_weight(w))
        return (acc * _out_scale(w, acc.dim())).to(x.dtype)
    return torch.matmul(x, dequantize(w, dtype=x.dtype))


def qmatmul_dx(g: torch.Tensor, w: dict, dtype: torch.dtype) -> torch.Tensor:
    """dX of ``qmatmul`` (frozen weight): (g * scale) @ W_int^T in
    ``dtype``, the straight-through form of the a8 backward."""
    gs = (g.float() * _out_scale(w, g.dim())).to(dtype)
    return torch.matmul(gs, int_weight(w).to(dtype).transpose(-1, -2))


def _a8_quantize(x: torch.Tensor, group=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8 over the last dim: int8 codes and
    (..., 1) fp32 scales; an all-zero row gets scale 1 (exact zeros).
    ``group``: x is this rank's columns of rows split over it; the max is
    the whole row's."""
    ax = x.abs().amax(dim=-1, keepdim=True).float()  # exact in x's dtype
    if group is not None:
        ax = comm.all_reduce_max(ax, group)
    sx = torch.where(ax == 0, torch.ones_like(ax), ax / 127.0)
    q = torch.round(x / sx).clamp_(-127, 127)  # x / sx: in fp32
    return q.to(torch.int8), sx


# ------------------------------------------------- int8 x int8 -> int32

def _pad_to(t: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    pad = (-t.shape[dim]) % multiple
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


# What is derived from a frozen 2-D weight (the lm_head: its
# ``torch._int_mm`` operands, the fused CE's padded copy), by the weight's
# id, kept while the weight lives: built once, not every step.  A stacked
# base's per-layer operands are not kept: they would hold an int8 copy of
# the whole base (the checkpoint keeps each layer's weight views alive
# until its backward).
_OPERANDS: dict[int, tuple] = {}


def operand_cache(t: torch.Tensor) -> dict:
    """The cache dict of weight ``t``, emptied when ``t`` is freed."""
    entry = _OPERANDS.get(id(t))
    if entry is None or entry[0]() is not t:
        entry = (weakref.ref(t), {})
        _OPERANDS[id(t)] = entry
        weakref.finalize(t, _OPERANDS.pop, id(t), None)
    return entry[1]


def _weight_operand(w: dict, transposed: bool) -> torch.Tensor:
    """W_int (k=d_in, n=d_out) or, ``transposed``, W_int^T (k=d_out,
    n=d_in) of a 2-D weight, each a column-major view (cuBLASLt's int8
    "TN" layout: ``torch._int_mm`` runs a row-major x column-major product
    at ~870 T ops/s and a row-major x row-major one at ~130 on an H100)
    with k and n padded with zeros to multiples of 8.  Built once and kept
    (``operand_cache``) for a weight that is a tensor of its own, as the
    lm_head; a layer's weight, a view into the layer-stacked base, keeps
    nothing (see ``_OPERANDS``)."""
    src = w["w_i4"] if "w_i4" in w else w["w_i8"]
    cache = operand_cache(src) if src._base is None else {}
    key = ("a8", transposed)
    if key not in cache:
        if transposed:    # store (n, k) = W row-major
            store = int_weight(w)
        elif "w_i4" in w:  # store W^T row-major, unpacked straight into it
            store = torch.cat(unpack_int4(w["w_i4"].t()), dim=-1)
        else:
            store = w["w_i8"].t()
        store = _pad_to(_pad_to(store, 0, 8), 1, 8).contiguous()
        cache[key] = store.t()
    return cache[key]


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact.  ``b`` is a
    prepared operand (``_weight_operand``; k, n multiples of 8); ``a`` is
    padded to k and to more than 16 rows, as ``torch._int_mm`` needs."""
    m = a.shape[0]
    k = b.shape[0]
    a = _pad_to(a, 1, 8) if a.shape[1] != k else a
    if m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, k))])
    return torch._int_mm(a.contiguous(), b)[:m]


def _a8_forward(x: torch.Tensor, w: dict, out_dtype) -> torch.Tensor:
    xq, sx = _a8_quantize(x)
    n = w["scale"].shape[-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]),
                      _weight_operand(w, False))[:, :n]
    acc = acc.reshape(*x.shape[:-1], n)
    out = (acc * sx).mul_(_out_scale(w, acc.dim()))  # int32 -> fp32 first
    return out.to(out_dtype or x.dtype)


def _a8_dx(g: torch.Tensor, w: dict, bwd_a8: bool,
           dtype: torch.dtype, group=None) -> torch.Tensor:
    """The straight-through dX of ``qmatmul_a8``: (g * sw) @ W_int^T in
    bf16 products with fp32 sums, or (``bwd_a8``) with g * sw quantized per
    token to int8 (sw varies along the contracted axis, so it folds in
    before the quantization; ``group``: g holds this rank's columns of
    rows split over it, and the scale is the whole row's)."""
    if not bwd_a8:
        return qmatmul_dx(g, w, dtype)
    gq, sg = _a8_quantize(g.float() * _out_scale(w, g.dim()), group)
    d_in = 2 * w["w_i4"].shape[-2] if "w_i4" in w else w["w_i8"].shape[-2]
    dx = int8_matmul(gq.reshape(-1, gq.shape[-1]),
                     _weight_operand(w, True))[:, :d_in]
    dx = dx.reshape(*g.shape[:-1], d_in)
    return (dx * sg).to(dtype)


class _A8Matmul(torch.autograd.Function):
    """``qmatmul_a8`` with the frozen weight kept on ctx and no tensor
    saved: a checkpoint recompute may skip it (``models.llama._RematSaves``)
    and the backward needs only W and its scale."""

    @staticmethod
    def forward(ctx, x, w, bwd_a8, out_dtype, group):
        ctx.w, ctx.bwd_a8, ctx.dtype, ctx.group = w, bwd_a8, x.dtype, group
        return _a8_forward(x, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        dx = _a8_dx(g, ctx.w, ctx.bwd_a8, ctx.dtype, ctx.group)
        return dx, None, None, None, None


def qmatmul_a8(x: torch.Tensor, w: dict, bwd_a8: bool = False,
               out_dtype=None, group=None) -> torch.Tensor:
    """x @ w with x dynamically quantized to int8 per token (W4A8 / W8A8):
    ``(acc * sx) * sw`` from the exact int32 product, in ``out_dtype``
    (default x's dtype).  Differentiable in x only (the weight is frozen);
    ``bwd_a8`` quantizes the scaled cotangent too (int8 dX products).
    ``group``: w holds this rank's output columns of a product split over
    it (column-parallel), so the cotangent's per-token scale is the whole
    row's."""
    return _A8Matmul.apply(x, w, bwd_a8, out_dtype, group)


# ------------------------------------------------- the save-set rounding

def q8_codes(y: torch.Tensor, group=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-token int8 codes and fp32 scales ``q8_roundtrip`` keeps
    (``group``: y is this rank's columns, the scale the whole row's)."""
    return _a8_quantize(y, group)


def q8_value(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def fp8_codes(y: torch.Tensor) -> torch.Tensor:
    """fp8-e4m3fn values of y; where |y| rounds past 448, NaN, as
    ``ml_dtypes`` converts (torch saturates instead)."""
    y = torch.where(y.abs() > FP8_TIE, torch.full_like(y, float("nan")), y)
    return y.to(torch.float8_e4m3fn)


class _RoundTrip(torch.autograd.Function):
    """Round y to its codes and back, with the identity gradient; ``keep``
    (or None) receives the codes (a checkpoint's save set)."""

    @staticmethod
    def forward(ctx, y, mode, keep, group):
        if mode == "fp8":
            codes = (fp8_codes(y),)
            out = codes[0].to(y.dtype)
        else:
            codes = q8_codes(y) if group is None else q8_codes(y, group)
            out = q8_value(*codes, y.dtype)
        if keep is not None:
            keep(codes)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def q8_roundtrip(y: torch.Tensor, keep=None, group=None) -> torch.Tensor:
    """Per-token int8 quantize -> dequantize, straight-through gradient
    (``group``: y is this rank's columns of rows split over it)."""
    return _RoundTrip.apply(y, "int8", keep, group)


def fp8_roundtrip(y: torch.Tensor, keep=None, group=None) -> torch.Tensor:
    """fp8-e4m3fn convert -> convert back, straight-through gradient
    (elementwise: ``group`` changes nothing)."""
    return _RoundTrip.apply(y, "fp8", keep, None)


def codes_value(codes: tuple, dtype) -> torch.Tensor:
    """What the roundtrip returned, from the codes it kept."""
    if len(codes) == 1:
        return codes[0].to(dtype)
    return q8_value(*codes, dtype)


# ------------------------------------------------- trees

def quantize_llama_base(base: dict, bits: int = 8,
                        head_bits: int | None = None) -> dict:
    """Quantize the seven projection families of a layer-stacked LLaMA
    tree; ``head_bits`` also the lm_head (d, V), per output channel."""
    quant = {8: quantize_int8, 4: quantize_int4}[bits]
    layers = dict(base["layers"])
    for name in QUANT_KEYS:
        layers[name] = quant(base["layers"][name], axis=-2)
    out = dict(base)
    out["layers"] = layers
    if head_bits:
        hq = {8: quantize_int8, 4: quantize_int4}[head_bits]
        out["lm_head"] = hq(base["lm_head"], axis=-2)
    return out


def quantize_encoder(params: dict, bits: int = 8, min_dim: int = 64) -> dict:
    """Weight-only quantization of a frozen tower tree (CLIP ViT, BEATs):
    every ``{"w": (..., d_in, d_out), "b"}`` leaf dict whose two matrix
    dims are both >= ``min_dim`` gets its weight replaced by a quantized
    dict (per output channel; a layer-stacked weight gets one scale per
    layer and channel).  Small heads (BEATs' (hd, 8) gate), norms,
    embeddings and convolution kernels stay as they are."""
    quant = {8: quantize_int8, 4: quantize_int4}[bits]

    def walk(node):
        if not isinstance(node, dict) or is_quantized(node):
            return node
        w = node.get("w")
        if (torch.is_tensor(w) and w.dim() >= 2
                and min(w.shape[-2:]) >= min_dim
                and (bits == 8 or w.shape[-2] % 2 == 0)):
            return {**{k: walk(v) for k, v in node.items() if k != "w"},
                    "w": quant(w, axis=-2)}
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def quantized_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(quantized_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def init_llama_params_quantized(generator: torch.Generator, cfg,
                                bits: int = 8, head_bits: int | None = None,
                                *, device=None) -> dict:
    """Random init (normal 0.02, bf16) straight into quantized form, one
    projection family at a time: peak memory is the quantized tree plus one
    bf16 family, never the whole bf16 tree.  ``generator`` must live on
    ``device`` (default: the card)."""
    from moka_tpu_torch.core.device import resolve_device
    from moka_tpu_torch.models.llama import _proj_shapes
    dev = resolve_device(device)
    n = cfg.n_layers
    quant = {8: quantize_int8, 4: quantize_int4}[bits]

    def w(shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * 0.02).to(torch.bfloat16)

    layers = {}
    for name, (d_in, d_out) in _proj_shapes(cfg).items():
        # a layer at a time (the scale reduces over d_in within a layer)
        parts = [quant(w((d_in, d_out))) for _ in range(n)]
        layers[name] = {k: torch.stack([p[k] for p in parts])
                        for k in parts[0]}
        del parts
    layers["attn_norm"] = torch.ones((n, cfg.dim), dtype=torch.bfloat16,
                                     device=dev)
    layers["mlp_norm"] = torch.ones((n, cfg.dim), dtype=torch.bfloat16,
                                    device=dev)
    lm_head = w((cfg.dim, cfg.vocab_size))
    if head_bits:
        lm_head = {8: quantize_int8, 4: quantize_int4}[head_bits](lm_head)
    return {"embed": w((cfg.vocab_size, cfg.dim)), "layers": layers,
            "final_norm": torch.ones((cfg.dim,), dtype=torch.bfloat16,
                                     device=dev),
            "lm_head": lm_head}


def import_llama_quantized(sd: dict, cfg, bits: int = 8,
                           head_bits: int | None = None, *,
                           device=None) -> dict:
    """Checkpoint import straight to int8/int4: each layer's projection
    weight is cast to bf16 on ``device`` (default: the card), quantized and
    written into the preallocated codes, so no bf16 projection family is
    ever whole.  Codes and scales equal ``quantize_llama_base(import_llama(
    sd))``'s bit for bit: the scale reduces over d_in within a layer."""
    from moka_tpu_torch.core.device import resolve_device
    from moka_tpu_torch.models.llama import _proj_shapes
    from moka_tpu_torch.train.import_torch import llama_weight, llama_whole
    dev = resolve_device(device)
    n = cfg.n_layers
    quant = {8: quantize_int8, 4: quantize_int4}[bits]
    layers = {}
    for name in _proj_shapes(cfg):
        codes = None
        for i in range(n):
            q = quant(llama_weight(sd, name, i, dev).to(torch.bfloat16))
            if codes is None:
                codes = {k: torch.empty((n, *v.shape), dtype=v.dtype,
                                        device=dev) for k, v in q.items()}
            for k, v in q.items():
                codes[k][i].copy_(v)
        layers[name] = codes
    for name in ("attn_norm", "mlp_norm"):
        layers[name] = torch.stack([
            llama_weight(sd, name, i, dev).to(torch.bfloat16)
            for i in range(n)])
    lm_head = llama_whole(sd, "lm_head", torch.bfloat16, dev)
    if head_bits:
        lm_head = {8: quantize_int8, 4: quantize_int4}[head_bits](lm_head)
    return {"embed": llama_whole(sd, "embed", torch.bfloat16, dev),
            "layers": layers,
            "final_norm": llama_whole(sd, "final_norm", torch.bfloat16, dev),
            "lm_head": lm_head}
