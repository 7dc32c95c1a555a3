"""Tensor parallelism on the mesh's ``model`` axis.

JAX's rule table (``parallel/sharding.py``) splits q, k, v, gate and up
on d_out and o and down on d_in over ``model``, and GSPMD inserts the
collectives that implies.  The port runs one process a rank and names
them here, in Megatron's layout.  Rank i of a model group of m ranks
holds, in each decoder layer:

- column-parallel q/k/v/gate/up: d_out columns [i d_out / m, (i + 1)
  d_out / m) of the weight (H/m query heads, K/m kv heads, so GQA's ratio
  is kept, intermediate/m FFN columns), and reads x whole.  Each block's
  input passes ``enter`` (``comm.sum_grads``: identity forward; its
  gradient, a part on each rank, summed over the group backward).  MokA's
  A products and rank attention run whole on every rank; the B product
  takes B's local columns.
- row-parallel o/down: d_in rows of the weight, and x's matching columns.
  ``row_matmul`` forms the partial product in fp32 (int32 for the a8
  product, whose per-token scale is the whole row's: an all-reduced max)
  and sums it over the group before it rounds, so the output is one
  process's to fp32 summation order (the a8 product's bit for bit).
  MokA's partial A products are summed too (``sum_a``:
  ``comm.sum_value``, all-reduce forward, identity backward) before the
  keys and the rank attention read them, which are not linear in them;
  then B runs whole and the delta is added once, to the summed output.
- where K % m != 0 the kv heads do not split: k and v are gathered whole
  on every rank (``WHOLE``) and each rank takes the kv heads of its query
  heads (``kv_heads``).

The lm_head and the embedding are gathered whole (``stream.fetch``), and
the loss runs replicated on every rank of a model group.

Gradients.  The adapters are replicated, and each rank of a model group
differentiates its own part of the layer.  A leaf's gradient is then
either whole (the same on every rank) or a part (the ranks' parts sum to
the whole), and ``grad_is_part`` says which:

  ==================  ========================  =======================
  leaf                q, k, v, gate, up         o, down
  ==================  ========================  =======================
  ``a``               part (the cotangent of    part (non-zero on the
                      the rank's B columns, or  rank's rows of A only)
                      heads, flows into it)
  ``b``               part (non-zero on the     whole
                      rank's columns; whole-kv
                      k/v: its heads' share)
  ==================  ========================  =======================

Every other trainable (projectors, Q-Formers, prompts) is computed whole
on every rank and its gradient is whole.  ``train.step`` sums the parts
over the model group and leaves the whole leaves as they are: summing
those would multiply them by m.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from moka_tpu_torch.ops.quant import (_a8_dx, _a8_quantize, _matmul_f32,
                                      _out_scale, _weight_operand,
                                      dequantize, int8_matmul, int_weight,
                                      is_quantized, qmatmul_dx)
from moka_tpu_torch.parallel import comm
from moka_tpu_torch.parallel.mesh import AXIS_MODEL, axis_size
from moka_tpu_torch.parallel.sharding import shard_info

ROW = ("o", "down")
WHOLE = ("k", "v")  # the leaves gathered whole where kv heads do not split


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """This rank's place in its model group: the group, its size and the
    rank's index in it; ``kv_whole``: k and v are gathered whole (K % m
    != 0)."""
    group: object
    size: int
    index: int
    kv_whole: bool = False

    def part(self, n: int) -> tuple[int, int]:
        """(first, count) of this rank's share of ``n`` split evenly."""
        return self.index * (n // self.size), n // self.size

    def layout(self, name: str) -> str:
        """"column", "row" or "whole" (k/v gathered whole) for projection
        ``name``."""
        if name in ROW:
            return "row"
        return "whole" if self.kv_whole and name in WHOLE else "column"

    def whole_leaves(self) -> tuple:
        return WHOLE if self.kv_whole else ()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif tree is not None:
        yield path, tree


def _model_split_dim(t) -> bool:
    info = shard_info(t)
    return info is not None and any(
        name == AXIS_MODEL for _, name in info.sharded_dims())


def model_split(layers: dict, cfg) -> ModelSplit | None:
    """The ``ModelSplit`` of a layer-stacked base whose leaves
    ``sharding.shard_params`` split over a ``model`` axis above 1, or None.
    Raises where the heads or the FFN columns do not split evenly, or where
    a projection the layout splits is whole."""
    mesh = None
    for _, t in _leaves(layers):
        info = shard_info(t)
        if info is not None and axis_size(info.mesh, AXIS_MODEL) > 1:
            mesh = info.mesh
            break
    if mesh is None:
        return None
    m = axis_size(mesh, AXIS_MODEL)
    if cfg.n_heads % m or cfg.intermediate % m:
        raise ValueError(f"tensor parallelism over {m} ranks needs the "
                         f"{cfg.n_heads} heads and the {cfg.intermediate} "
                         f"FFN columns to split evenly")
    for name in ("q", "o", "gate", "up", "down"):
        if not any(_model_split_dim(t) for _, t in _leaves(layers[name])):
            raise ValueError(f"projection {name} is not split over the model "
                             f"axis of {m}: place the base with "
                             f"parallel.sharding.shard_params")
    return ModelSplit(mesh.get_group(AXIS_MODEL), m,
                      mesh.get_local_rank(AXIS_MODEL),
                      kv_whole=cfg.n_kv_heads % m != 0)


def kv_heads(n_heads: int, n_kv_heads: int, split: ModelSplit):
    """Where k and v are whole (``kv_whole``), the kv heads this rank's
    query heads read: a slice when they are a run the flash kernels map in
    GQA's way (each query head j of the rank to kv head j // ratio), else
    an index tensor of one kv head per query head."""
    hl = n_heads // split.size
    q0 = split.index * hl
    g = n_heads // n_kv_heads
    if hl % g == 0:
        return slice(q0 // g, (q0 + hl) // g)
    if g % hl == 0:
        return slice(q0 // g, q0 // g + 1)
    return torch.tensor([(q0 + j) // g for j in range(hl)])


def enter(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """The input of a column-parallel block (x whole on every rank): x
    itself, its gradient summed over the model group."""
    return comm.sum_grads([x], split.group)[0]


def sum_a(split: ModelSplit):
    """``moka_delta``'s ``sum_a`` for a row-parallel projection."""
    return lambda t: comm.sum_value(t, split.group)


class _RowMatmul(torch.autograd.Function):
    """x @ w for this rank's columns of x and rows of a frozen w (a tensor
    or a quantized dict), summed over the model group before the
    rounding; w is kept on ctx, not saved (``models.llama._FrozenMatmul``),
    so a remat recompute may skip the product."""

    @staticmethod
    def forward(ctx, x, w, group, a8, bwd_a8):
        ctx.w, ctx.dtype, ctx.a8, ctx.bwd_a8 = w, x.dtype, a8, bwd_a8
        if not is_quantized(w):
            return comm.all_reduce_(_matmul_f32(x, w), group).to(x.dtype)
        if a8:
            xq, sx = _a8_quantize(x, group)
            n = w["scale"].shape[-1]
            acc = int8_matmul(xq.reshape(-1, xq.shape[-1]),
                              _weight_operand(w, False))[:, :n].contiguous()
            acc = comm.all_reduce_(acc, group).reshape(*x.shape[:-1], n)
            return (acc * sx).mul_(_out_scale(w, acc.dim())).to(x.dtype)
        if "w_i4" in w:
            acc = comm.all_reduce_(_matmul_f32(x, int_weight(w)), group)
            return (acc * _out_scale(w, acc.dim())).to(x.dtype)
        acc = _matmul_f32(x, dequantize(w, dtype=x.dtype))
        return comm.all_reduce_(acc, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w = ctx.w
        if not is_quantized(w):
            dx = torch.matmul(g, w.t().to(g.dtype))
        elif ctx.a8:
            dx = _a8_dx(g, w, ctx.bwd_a8, ctx.dtype)
        else:
            dx = qmatmul_dx(g, w, ctx.dtype)
        return dx, None, None, None, None


def row_matmul(x: torch.Tensor, w, split: ModelSplit,
               a8: bool | str = False) -> torch.Tensor:
    """The row-parallel frozen product (plain, weight-only quantized, or
    with ``a8`` on a quantized weight and a 3-D x the W4A8/W8A8 product,
    "full": int8 dX products too), whole on every rank, in x's dtype.  Its
    backward is the rank's columns of dX: whole, from the whole
    cotangent."""
    use_a8 = bool(a8) and is_quantized(w) and x.dim() == 3
    return _RowMatmul.apply(x, w, split.group, use_a8,
                            use_a8 and a8 == "full")


def grad_is_part(path: str) -> bool:
    """Whether the gradient of trainable leaf ``path`` ("adapters/layers/
    q/a", ...) on a rank of a model group is a part of the whole (summed
    over the group) rather than whole (see the module docstring)."""
    m = re.fullmatch(r"(?:.*/)?adapters/layers/(\w+)/(a|b)", path)
    return m is not None and (m.group(2) == "a" or m.group(1) not in ROW)
