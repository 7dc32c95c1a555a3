"""Generic adapter-training step (port of ``moka_tpu/train/step.py``).

The parameters are split into a trainable tree and a frozen one; the loss
is differentiated with respect to the trainable leaves only, so no
gradient of the frozen base is ever formed.  Where the JAX step donates
its state and returns a new one, this step updates the trainable tree and
the optimizer state in place and returns a new ``TrainState`` that holds
them.

Under a mesh (``make_train_step(mesh=...)``) each rank feeds its own
samples and its loss function returns its share of the global loss (the
losses' ``mesh`` option); the step sums the shares and the trainables'
gradients over the mesh's data x fsdp group (one flat all-reduce) before
the global norm, the clipping and AdamW, so every rank applies the same
update to its replica of the trainables, as JAX's step does once.  With a
``model`` axis above 1 the data group is the data x fsdp ranks of this
rank's model coordinate, and the gradients that are parts on a rank of a
model group (``parallel.tensor.grad_is_part``: every adapter leaf but
o's and down's B) are summed over the model group too, in a second flat
all-reduce; the whole ones (o/down B, projectors, Q-Formers) are not.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.parallel import comm
from moka_tpu_torch.parallel import tensor as tp
from moka_tpu_torch.parallel.mesh import AXIS_MODEL, axis_size, \
    data_parallel_group, model_parallel_group
from moka_tpu_torch.train.optim import AdamW, OptState, global_norm, \
    tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any           # trainable tree (fp32 master)
    opt_state: OptState
    rng: DropoutKey


def init_train_state(params, tx: AdamW, rng: DropoutKey) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      rng=rng)


def make_train_step(loss_fn: Callable, tx: AdamW,
                    grad_taps: Callable | None = None, mesh=None):
    """loss_fn(trainable, frozen, batch, rng) -> (loss, metrics dict).

    grad_taps(grads) -> a small tree surfaced as metrics["grad_taps"].
    mesh: sum the loss and the gradients over its data x fsdp group (the
    loss must be the rank's share: see the module docstring).
    Returns step(state, frozen, batch) -> (state, metrics) with the loss,
    the global norm of the (unclipped) gradients and the loss's metrics, as
    0-dim tensors on the parameters' device."""
    group = data_parallel_group(mesh)
    model_group = model_parallel_group(mesh) \
        if axis_size(mesh, AXIS_MODEL) > 1 else None

    def step(state: TrainState, frozen, batch):
        rng, sub = state.rng.split(2)
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(state.params, frozen, batch, sub)
            # a leaf with no path to the loss (a Q-Former's text branch
            # without question text, the adapters in stage 1) gets zeros,
            # as JAX's grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        loss = loss.detach()
        if group is not None:
            *grads, loss = comm.flat_all_reduce([*grads, loss], group)
        if model_group is not None:
            grads = _sum_parts(grads, _paths(state.params), model_group)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), state.params)
        tx.update(grads, state.opt_state, state.params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        if grad_taps is not None:
            metrics["grad_taps"] = grad_taps(grads)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state, rng=rng), metrics

    return step


def _paths(tree, prefix: str = "") -> list[str]:
    """The key paths of ``tree_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, f"{prefix}/{i}")]
    return [prefix]


def _sum_parts(grads: list, paths: list, group) -> list:
    """``grads`` with the parts (``tensor.grad_is_part``) summed over the
    model group in one flat all-reduce."""
    parts = [i for i, p in enumerate(paths) if tp.grad_is_part(p)]
    out = list(grads)
    for i, g in zip(parts, comm.flat_all_reduce([grads[i] for i in parts],
                                                 group)):
        out[i] = g
    return out

