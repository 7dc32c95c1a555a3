"""Generic adapter-training step (port of ``moka_tpu/train/step.py``).

The parameters are split into a trainable tree and a frozen one; the loss
is differentiated with respect to the trainable leaves only, so no
gradient of the frozen base is ever formed.  Where the JAX step donates
its state and returns a new one, this step updates the trainable tree and
the optimizer state in place and returns a new ``TrainState`` that holds
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from moka_tpu_torch.core.rng import DropoutKey
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
                    grad_taps: Callable | None = None):
    """loss_fn(trainable, frozen, batch, rng) -> (loss, metrics dict).

    grad_taps(grads) -> a small tree surfaced as metrics["grad_taps"].
    Returns step(state, frozen, batch) -> (state, metrics) with the loss,
    the global norm of the (unclipped) gradients and the loss's metrics, as
    0-dim tensors on the parameters' device."""

    def step(state: TrainState, frozen, batch):
        rng, sub = state.rng.split(2)
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(state.params, frozen, batch, sub)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), state.params)
        tx.update(grads, state.opt_state, state.params)
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        if grad_taps is not None:
            metrics["grad_taps"] = grad_taps(grads)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state, rng=rng), metrics

    return step

