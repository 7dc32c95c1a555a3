"""The collectives the port's parallelism names, and how each group moves
its tensors.

JAX's collectives ride the interconnect wherever XLA puts them; here a
group's backend decides (``transport``).  An NCCL group (one GPU a rank,
the real deployment) moves device tensors.  A gloo group serves ranks on
the CPU and several ranks that share one GPU, where NCCL refuses to run:
its all-reduce, broadcast and all-gather take CUDA tensors as they are,
and its point-to-point sends get host copies (a CUDA tensor in a gloo
send aborts the process: ``gloo::IoException ... writev: Bad address``,
read with ``profile_port.py gloo_cuda`` on torch 2.11.0+cu128).  The
transport is chosen from the group's backend and the collective, never
by trying one and catching its error.

Besides the plain collectives, four autograd functions: ``ring_shift``
(k/v to the next rank of a ring, the gradients back the other way),
``gather_seq`` (a sequence all-gather whose backward sums the gradients
back to their shard), ``sum_value`` (a value summed over a group, its
gradient passed through) and ``sum_grads`` (tensors passed through, their
gradients summed over a group in one flat all-reduce).  The last two are
Megatron's conjugate pair of tensor parallelism (``parallel.tensor``):
``sum_value`` ends a row-parallel block, ``sum_grads`` starts a
column-parallel one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


GLOO_DEVICE_OPS = ("all_reduce", "all_gather", "broadcast")

REDUCED_BYTES: dict = {}  # bytes each group has all-reduced (by group)


def transport(group, op: str) -> str:
    """How collective ``op`` of ``group`` moves a CUDA tensor: "device"
    (as it is) on an NCCL group and for gloo's ``GLOO_DEVICE_OPS``, "host"
    (a host copy) for gloo's point-to-point sends."""
    if dist.get_backend(group) == "nccl" or op in GLOO_DEVICE_OPS:
        return "device"
    return "host"


def group_size(group) -> int:
    return dist.get_world_size(group)


def _out(t: torch.Tensor, group, op: str) -> tuple[torch.Tensor, bool]:
    """The tensor collective ``op`` of ``group`` takes for ``t``, and
    whether it is a host copy that has to go back to ``t``'s device."""
    t = t.contiguous()
    if t.is_cuda and transport(group, op) == "host":
        return t.cpu(), True
    return t, False


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (a sum, or ``op``); returns
    it."""
    if group_size(group) == 1:
        return t
    buf, back = _out(t, group, "all_reduce")
    REDUCED_BYTES[group] = REDUCED_BYTES.get(group, 0) + \
        buf.numel() * buf.element_size()
    dist.all_reduce(buf, op=op, group=group)
    if back or buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``."""
    return all_reduce_(t.detach().clone(), group)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the elementwise max of ``t`` over ``group`` (the
    per-token scales of a row split over the model axis)."""
    return all_reduce_(t.detach().clone(), group, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    buf, back = _out(t, group, "all_gather")
    if dim == 0 and dist.get_backend(group) == "nccl":
        out = buf.new_empty((n * buf.shape[0], *buf.shape[1:]))
        dist.all_gather_into_tensor(out, buf, group=group)
        return out
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if back else out


def ring_exchange(tensors, group, reverse: bool = False) -> list:
    """Each rank sends ``tensors`` to the next rank of ``group`` (in
    group-rank order, wrapping) and returns what the previous one sent;
    ``reverse``: to the previous, from the next."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    step = -1 if reverse else 1
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    ops, recv, backs = [], [], []
    for t in tensors:
        buf, back = _out(t, group, "send")
        got = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, to, group))
        ops.append(dist.P2POp(dist.irecv, got, frm, group))
        recv.append(got)
        backs.append(t.device if back else None)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [g if dev is None else g.to(dev) for g, dev in zip(recv, backs)]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(ring_exchange(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, *ring_exchange(grads, ctx.group, reverse=True))


def ring_shift(group, *tensors) -> tuple:
    """``ring_exchange`` that autograd differentiates: the gradients of
    what this rank received go back to the rank that sent it."""
    return _RingShift.apply(group, *tensors)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.length = group, dim, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.length
        return g.narrow(ctx.dim, start, ctx.length), None, None


def gather_seq(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """All-gather equal shards along ``dim``; the backward sums every
    rank's gradient of the whole and hands each rank its shard's part."""
    return _GatherSeq.apply(t, group, dim)


class _SumValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_value(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, with the gradient of the sum passed to
    this rank's ``t`` unchanged: each rank differentiates its own part, and
    ``sum_grads`` adds the parts up."""
    return _SumValue.apply(t, group)


def flat_all_reduce(tensors, group) -> list:
    """Sum a list of tensors over ``group`` in one all-reduce of their
    fp32 concatenation; returns new tensors in the inputs' dtypes."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, *flat_all_reduce(grads, ctx.group))


def sum_grads(tensors, group) -> list:
    """The tensors themselves, with their gradients summed over ``group``
    in the backward (one all-reduce for all of them)."""
    if not tensors:
        return []
    return list(_SumGrads.apply(group, *tensors))
