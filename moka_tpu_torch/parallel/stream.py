"""Bringing a sharded or host-resident frozen base to the compute device,
one use (or one layer) at a time.

Two kinds of leaf need it: an fsdp-sharded local slice
(``sharding.shard_params``), all-gathered over its fsdp group, and a leaf
in pinned host memory (``host_offload``), copied to the card.  A layer's
``model`` dims stay local (the rank's part of a tensor-parallel product,
``parallel.tensor``), except in the leaves named ``whole`` (k and v where
the kv heads do not split over the model axis), which are gathered over
model too; a leaf used whole (``fetch``) is gathered over every split
dim.  ``fetch``
does both for a leaf used whole (the embedding table, the final norm, the
lm_head).  ``LayerStream`` does it for the decoder's stacked layers: the
forward (``models.llama``) asks for layer i inside the function that
``torch.utils.checkpoint`` wraps, so a remat recompute fetches it again
instead of the checkpoint holding a device copy of every layer.  After a
layer's forward its fetched tensors are freed (their storage resized to
0); a hook on the layer's output refills the same tensors when the
backward reaches the layer (ops that keep a weight on their context,
``_FrozenMatmul``, read it there) and frees the layer after it.  Host
copies run on a side stream with the next layer prefetched: the side
stream waits for the compute stream's queued work before it writes (a
buffer may reuse memory that work still reads), the compute stream waits
for the copy before it reads, and the device copies are recorded on the
side stream.  A base on the CPU with a CPU
compute device runs the same path, and its "copy" is the host tensor
itself: there is no device memory to stream into.

``COUNTS`` tallies what moved: layers fetched, bytes copied host to
device, bytes all-gathered.
"""

from __future__ import annotations

import functools

import torch

from moka_tpu_torch.parallel import comm
from moka_tpu_torch.parallel.sharding import shard_info

COUNTS = {"layer_fetches": 0, "h2d_bytes": 0, "gathered_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaves(tree):
    """(key path, tensor) of a weight or a quantized dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            for path, t in _leaves(v):
                yield (k, *path), t
    elif tree is not None:
        yield (), tree


def _set(tree, path, value):
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _set(tree.get(path[0], {}), path[1:], value)
    return out


def elsewhere(tree, device: torch.device) -> bool:
    """Whether a leaf (or quantized dict) of ``tree`` lives on another
    device than ``device``."""
    return any(t.device != device for _, t in _leaves(tree))


def _gathers(path: tuple, t: torch.Tensor, whole: tuple) -> list:
    """The split dims of leaf ``t`` (at key path ``path`` of a layer) that
    a layer's use gathers (``ShardInfo.gathered_dims``)."""
    info = shard_info(t)
    if info is None:
        return []
    return info.gathered_dims(bool(path) and path[0] in whole)


def needs_fetch(tree, device: torch.device, whole: tuple = ()) -> bool:
    """Whether a leaf of ``tree`` is elsewhere or split on a dim a layer's
    use gathers (``whole``: the names whose model dims are gathered)."""
    return elsewhere(tree, device) or \
        any(_gathers(path, t, whole) for path, t in _leaves(tree))


def _gather(local: torch.Tensor, dims: list, mesh, drop_layer: bool,
            device: torch.device) -> torch.Tensor:
    """The tensor whole along ``dims`` ((dim, axis) of the placement) from
    this rank's slice: an all-gather over each dim's group
    (``drop_layer``: ``local`` is one layer of a stacked leaf, one dim
    fewer than the placement)."""
    out = local.to(device, non_blocking=True)
    for dim, name in dims:
        d = dim - 1 if drop_layer else dim
        out = comm.all_gather(out, mesh.get_group(name), d)
    COUNTS["gathered_bytes"] += _nbytes(out)
    return out


def fetch(tree, device):
    """A leaf (or quantized dict) whole on ``device``: gathered if sharded,
    copied if elsewhere, itself otherwise."""
    device = torch.device(device)
    for path, t in list(_leaves(tree)):
        info = shard_info(t)
        if info is not None:
            tree = _set(tree, path, _gather(t, info.sharded_dims(), info.mesh,
                                            False, device))
        elif t.device != device:
            COUNTS["h2d_bytes"] += _nbytes(t)
            tree = _set(tree, path, t.to(device, non_blocking=True))
    return tree


class LayerRef:
    """Layer ``i`` of a ``LayerStream``, passed to the checkpointed layer
    function in place of its weights: ``get()`` fetches them there."""

    __slots__ = ("stream", "i")

    def __init__(self, stream: "LayerStream", i: int):
        self.stream, self.i = stream, i

    def get(self) -> dict:
        return self.stream.get(self.i)


class LayerStream:
    """One forward call's per-layer fetches of a stacked ``layers`` dict.

    ``recompute``: the layers run under a checkpoint whose backward needs
    them again (the forward frees each and the backward refills it); else,
    with gradients on, fetched layers are kept for the backward, and
    without gradients each is freed after its forward.  ``whole``: the
    names of the layer's leaves gathered over the model axis too."""

    def __init__(self, layers: dict, device, n_layers: int, recompute: bool,
                 whole: tuple = ()):
        self.layers = layers
        self.paths = list(_leaves(layers))
        self.dims = [_gathers(path, t, whole) for path, t in self.paths]
        self.device = torch.device(device)
        self.n = n_layers
        self.recompute = recompute
        self.slots: dict[int, dict] = {}
        self.live: set[int] = set()
        self.ready: dict[int, torch.cuda.Event] = {}
        self.direction = 1  # the forward walks up, the backward down
        sharded = any(self.dims)
        host = any(t.device != self.device for _, t in self.paths)
        # host copies overlap compute on a side stream, one layer ahead;
        # gathers are collectives and run in order on the compute stream
        self.side = torch.cuda.Stream(self.device) if \
            host and self.device.type == "cuda" and not sharded else None

    def ref(self, i: int) -> LayerRef:
        return LayerRef(self, i)

    def _fill(self, i: int) -> None:
        slot = self.slots.setdefault(i, {})
        if self.side is not None:
            # the buffers below may reuse memory that the compute stream
            # freed but its queued kernels still read: copy after them
            self.side.wait_stream(torch.cuda.current_stream(self.device))
        for (path, stacked), dims in zip(self.paths, self.dims):
            src = stacked[i]
            if dims:
                slot[path] = _into(slot.get(path), _gather(
                    src, dims, shard_info(stacked).mesh, True, self.device))
            elif src.device == self.device:
                slot[path] = src  # resident: a view, nothing to free
            else:
                dst = slot.get(path)
                if dst is None:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      device=self.device)
                else:
                    dst.untyped_storage().resize_(_nbytes(dst))
                if self.side is not None:
                    with torch.cuda.stream(self.side):
                        dst.copy_(src, non_blocking=True)
                    dst.record_stream(self.side)
                else:
                    dst.copy_(src, non_blocking=True)
                COUNTS["h2d_bytes"] += _nbytes(dst)
                slot[path] = dst
        if self.side is not None:
            self.ready[i] = self.side.record_event()
        self.live.add(i)
        COUNTS["layer_fetches"] += 1

    def get(self, i: int) -> dict:
        """Layer i's weights on the device (the stacked dict's structure),
        fetched if they are not live; with a side stream, the next layer in
        the walk's direction starts copying too."""
        if i not in self.live:
            self._fill(i)
        if self.side is not None:
            nxt = i + self.direction
            if 0 <= nxt < self.n and nxt not in self.live:
                self._fill(nxt)
            ev = self.ready.pop(i, None)
            if ev is not None:
                torch.cuda.current_stream(self.device).wait_event(ev)
        out = {}
        for path, t in self.slots[i].items():
            out = _set(out, path, t)
        return out

    def release(self, i: int) -> None:
        """Free layer i's fetched tensors (the tensor objects stay, for a
        refill); views of a resident leaf are left alone."""
        if i not in self.live:
            return
        self.live.discard(i)
        self.ready.pop(i, None)
        for (path, stacked), t in zip(self.paths, self.slots[i].values()):
            if t.untyped_storage().data_ptr() != \
                    stacked.untyped_storage().data_ptr():
                t.untyped_storage().resize_(0)

    def after_forward(self, i: int, h: torch.Tensor) -> None:
        """Called with layer i's output: frees the layer unless the backward
        reads the fetched tensors themselves, and, under a recompute, hooks
        the refill onto the output's gradient."""
        if self.recompute:
            self.release(i)
            if h.requires_grad:
                h.register_hook(functools.partial(self._backward_enter, i))
        elif not torch.is_grad_enabled():
            self.release(i)

    def _backward_enter(self, i: int, grad):
        self.direction = -1
        self.release(i + 1)
        self.get(i)
        return None


def _into(dst, whole: torch.Tensor) -> torch.Tensor:
    """``whole`` as a slot's tensor: the first fill takes it, a refill
    writes it into the tensor the backward's nodes hold."""
    if dst is None:
        return whole
    dst.untyped_storage().resize_(_nbytes(dst))
    dst.copy_(whole)
    return dst
