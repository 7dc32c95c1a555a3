"""Parameter sharding rules (port of ``moka_tpu/parallel/sharding.py``).

The same rule table as JAX: the frozen base is sharded over the ``fsdp``
axis (and the projections over ``model``), the adapters and the encoders
stay replicated.  Specs are tuples of axis names (or None) per dim, as
JAX's ``PartitionSpec`` reads as a tuple.

Where JAX places each leaf on the mesh and XLA all-gathers it per use,
``shard_params`` gives each rank its local slice as a plain tensor and
records the placement on it; ``models.llama.forward`` gathers a layer
inside its remat region (``parallel.stream``), so the recompute gathers it
again and the gathered copy is freed after the layer.  No DTensor reaches
a layer: the CUDA kernels take plain tensors.  ``host_offload`` keeps the
slices in pinned host memory, from which ``forward(host_stream=...)``
copies one layer at a time to the card.

The ``model`` axis is not ported: a spec that names it on a mesh where it
is larger than 1 raises (ROADMAP.md, item 4b).
"""

from __future__ import annotations

import dataclasses
import re

import torch

from moka_tpu_torch.parallel.mesh import (AXIS_MODEL, TENSOR_PARALLEL,
                                          Placement, axis_size)

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
    """The leaf's spec on ``mesh``; raises where it would shard over a
    ``model`` axis larger than 1."""
    spec = _divisible_spec(mesh, spec_for_path(path, len(shape)), shape)
    if axis_size(mesh, AXIS_MODEL) > 1 and \
            any(AXIS_MODEL in _names(p) for p in spec):
        raise NotImplementedError(f"{path}: {TENSOR_PARALLEL}")
    return spec


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


def shard_params(mesh, params, host_offload: bool = False):
    """Each rank's local slice of every leaf (a plain tensor), its
    ``Placement`` recorded on it (``shard_info``) where it is split;
    ``host_offload`` moves the slices to pinned host memory.  Leaves the
    rules replicate, and every leaf without a mesh, stay whole (and where
    they are, unless offloaded)."""
    shardings = param_shardings(mesh, params, host_offload)

    def one(path, leaf):
        placement = _get(shardings, path)
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
