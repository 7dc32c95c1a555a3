"""Parameter sharding rules (port of ``moka_tpu/parallel/sharding.py``).

The same rule table as JAX: the frozen base is sharded over the ``fsdp``
axis (and the projections over ``model``), the adapters and the encoders
stay replicated.  Specs are tuples of axis names (or None) per dim, as
JAX's ``PartitionSpec`` reads as a tuple.

Where JAX places each leaf on the mesh and XLA all-gathers it per use,
``shard_params`` gives each rank its local slice as a plain tensor and
records the placement on it; ``models.llama.forward`` gathers a layer's
fsdp dims inside its remat region (``parallel.stream``), so the recompute
gathers them again and the gathered copy is freed after the layer.  The
``model`` dims stay local: the column- and row-parallel products consume
the rank's slice (``parallel.tensor``).  No DTensor reaches a layer: the
CUDA kernels take plain tensors.  ``host_offload`` keeps the slices in
pinned host memory, from which ``forward(host_stream=...)`` copies one
layer at a time to the card.

An int4 o/down weight (``w_i4``: input rows [0, h) in the low nibbles,
[h, 2h) in the high ones) is repacked on the model axis: a contiguous
slice of its packed rows would hold input rows [a, b) and [h + a, h + b),
not the block of heads or FFN columns the rank's x holds, so each rank
unpacks its own block of input rows and packs it again, its first half
in the low nibbles (``_model_rows_int4``).
"""

from __future__ import annotations

import dataclasses
import re

import torch

from moka_tpu_torch.parallel.mesh import AXIS_MODEL, Placement, axis_size

# (path regex, spec) pairs; the first match wins.  Paths look like
# "llama/layers/q", "adapters/layers/q/a", "llama/embed", ...
# Layer-stacked arrays have a leading n_layers axis (never sharded).
RULES: list[tuple[str, tuple]] = [
    # --- frozen LLaMA base (layer-stacked) ---
    (r".*layers/(q|k|v)$",        (None, "fsdp", "model")),
    (r".*layers/o$",              (None, "model", "fsdp")),
    (r".*layers/(gate|up)$",      (None, "fsdp", "model")),
    (r".*layers/down$",           (None, "model", "fsdp")),
    # --- quantized base: {w_i8|w_i4, scale} leaves (ops/quant.py); the
    # per-out-channel (N, 1, d_out) scale follows the weight's output axis
    (r".*layers/(q|k|v|gate|up)/w_i[84]$",  (None, "fsdp", "model")),
    (r".*layers/(q|k|v|gate|up)/scale$",    (None, None, "model")),
    (r".*layers/(o|down)/w_i[84]$",         (None, "model", "fsdp")),
    (r".*layers/(o|down)/scale$",           (None, None, "fsdp")),
    (r".*layers/(attn_norm|mlp_norm)$", (None, None)),
    # these leaves sit at the tree root when the llama dict is sharded
    # bare ("lm_head"), under a prefix otherwise
    (r"(.*/)?embed$",             (None, "fsdp")),
    (r"(.*/)?lm_head$",           ("fsdp", "model")),
    (r"(.*/)?lm_head/w_i[84]$",   ("fsdp", "model")),
    (r"(.*/)?lm_head/scale$",     (None, "model")),
    (r"(.*/)?final_norm$",        (None,)),
    # --- adapters: replicated (a few MB) ---
    (r".*adapters.*",             ()),
    # --- encoders / projectors: replicated ---
    (r".*",                       ()),
]


def spec_for_path(path: str, ndim: int) -> tuple:
    for pat, spec in RULES:
        if re.fullmatch(pat, path):
            parts = list(spec) + [None] * (ndim - len(spec))
            return tuple(parts[:ndim])
    return ()


def _divisible_spec(mesh, spec: tuple, shape) -> tuple:
    """Drop the spec entries whose axis product does not divide the dim
    (the resized vocab 32011 cannot split over 2); the rest is kept."""
    parts = []
    for dim, part in zip(shape, spec):
        if part is None:
            parts.append(None)
            continue
        names = part if isinstance(part, tuple) else (part,)
        n = 1
        for name in names:
            n *= axis_size(mesh, name)
        parts.append(part if dim % n == 0 else None)
    return tuple(parts)


def _names(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _resolved(mesh, path: str, shape) -> tuple:
    """The leaf's spec on ``mesh``."""
    return _divisible_spec(mesh, spec_for_path(path, len(shape)), shape)


def _map(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(prefix, tree)


def param_shardings(mesh, params, host_offload: bool = False) -> dict:
    """A ``Placement`` per leaf of ``params`` (tensors, or anything with a
    ``shape``); ``host_offload`` places them in pinned host memory.
    ``mesh`` may be a ``DeviceMesh``, a ``MeshConfig`` or None (one
    process)."""
    kind = "pinned_host" if host_offload else "device"
    return _map(lambda path, leaf: Placement(
        _resolved(mesh, path, tuple(leaf.shape)), kind), params)


def stream_shardings(mesh, params) -> dict:
    """Device placements for streaming a host-resident base per use
    (``llama.forward(host_stream=...)``): the ``layers`` leaves lose their
    stacked layer axis (one layer is fetched at a time), the other leaves
    keep their rule."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_path(path, len(shape))
        if "layers/" in path:
            spec, shape = spec[1:], shape[1:]
        return Placement(_divisible_spec(mesh, spec, shape), "device")
    return _map(one, params)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """What ``shard_params`` records on a sharded local tensor: its
    placement and the mesh."""
    placement: Placement
    mesh: object

    def sharded_dims(self) -> list[tuple[int, str]]:
        """(dim, axis) of every dim split over an axis larger than 1."""
        return [(d, name) for d, p in enumerate(self.placement.spec)
                for name in _names(p) if axis_size(self.mesh, name) > 1]

    def gathered_dims(self, whole: bool = False) -> list[tuple[int, str]]:
        """The split dims a use gathers: those over fsdp (and data), which
        hold parts of the rank's own work; ``whole``: every split dim, the
        ``model`` ones too (a leaf used whole on every rank)."""
        return [(d, name) for d, name in self.sharded_dims()
                if whole or name != AXIS_MODEL]


def shard_info(t) -> ShardInfo | None:
    return getattr(t, "_moka_shard", None)


def _local(mesh, t: torch.Tensor, spec: tuple) -> torch.Tensor:
    out = t
    for dim, part in enumerate(spec):
        for name in _names(part):
            n = axis_size(mesh, name)
            if n > 1:
                size = out.shape[dim] // n
                out = out.narrow(dim, mesh.get_local_rank(name) * size, size)
    return out


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, pinned when there is a card to copy to (one
    copy, straight into the pinned buffer)."""
    if not torch.cuda.is_available():
        return t.detach().to("cpu")
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t.detach())
    return out


def _model_rows_int4(mesh, packed: torch.Tensor, spec: tuple
                     ) -> torch.Tensor:
    """This rank's slice of a row-parallel int4 weight (..., h, d_out),
    packed rows on the ``model`` axis: its block of the 2h input rows,
    repacked (first half low nibbles, second half high), and its d_out
    slice of the other split dims."""
    from moka_tpu_torch.ops.quant import pack_int4, unpack_int4
    dim = next(d for d, p in enumerate(spec) if AXIS_MODEL in _names(p))
    rows = torch.cat(unpack_int4(packed), dim=dim)
    n = axis_size(mesh, AXIS_MODEL)
    size = rows.shape[dim] // n
    mine = rows.narrow(dim, mesh.get_local_rank(AXIS_MODEL) * size, size)
    rest = tuple(None if AXIS_MODEL in _names(p) else p for p in spec)
    return pack_int4(_local(mesh, mine, rest), dim)


def _repacked(path: str, spec: tuple, mesh) -> bool:
    return bool(re.fullmatch(r".*layers/(o|down)/w_i4", path)) and \
        axis_size(mesh, AXIS_MODEL) > 1 and \
        any(AXIS_MODEL in _names(p) for p in spec)


def shard_params(mesh, params, host_offload: bool = False):
    """Each rank's local slice of every leaf (a plain tensor), its
    ``Placement`` recorded on it (``shard_info``) where it is split;
    ``host_offload`` moves the slices to pinned host memory.  Leaves the
    rules replicate, and every leaf without a mesh, stay whole (and where
    they are, unless offloaded).  A row-parallel int4 weight's slice is
    repacked (``_model_rows_int4``)."""
    shardings = param_shardings(mesh, params, host_offload)

    def one(path, leaf):
        placement = _get(shardings, path)
        if _repacked(path, placement.spec, mesh):
            local = _model_rows_int4(mesh, leaf, placement.spec)
        else:
            local = _local(mesh, leaf, placement.spec)
        if local is not leaf:
            local = local.contiguous().clone()
        if host_offload:
            local = _pinned(local)
        if local is not leaf and any(axis_size(mesh, n) > 1 for p in
                                     placement.spec for n in _names(p)):
            local._moka_shard = ShardInfo(placement, mesh)
        return local
    return _map(one, params)


def _get(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def constrain(mesh, x, *spec_parts):
    """JAX's activation sharding constraint: each rank holds its local batch
    already, so there is nothing to do."""
    return x
