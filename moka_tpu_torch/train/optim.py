"""Optimizer: global-norm clipping, then AdamW under a warmup + cosine (or
linear, or constant) schedule, with optional gradient accumulation (port
of ``moka_tpu/train/optim.py``).

The JAX package chains optax transformations; this module repeats optax's
arithmetic on plain tensors, not ``torch.optim``'s:

- clipping keeps the gradients when their global norm is below
  ``max_grad_norm`` and otherwise takes ``(g / norm) * max_grad_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- AdamW: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction by ``1 - b^count`` with the count after the increment,
  ``u = mu_hat / (sqrt(nu_hat) + eps) + wd * p``, then ``p += -lr * u``;
- the schedule is read at the count *before* the increment, so under
  warmup the first update has learning rate 0;
- ``grad_accum > 1`` is ``optax.MultiSteps``: the running mean of the
  micro-step gradients goes through clipping and AdamW every
  ``grad_accum``-th call, and the other calls leave the parameters alone.

Trees are nested dicts of tensors, walked in sorted-key order as JAX
flattens dicts.  ``AdamW.update`` changes the parameters and the state in
place (the JAX step donates them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from moka_tpu_torch.core.config import TrainConfig


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def _f32(x: float) -> float:
    """x rounded to fp32."""
    return float(torch.tensor(x, dtype=torch.float32))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


def _linear(init: float, end: float, steps: int):
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive steps, {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _join(schedules, boundaries):
    """``optax.join_schedules``: each later schedule takes over at its
    boundary, counting from it."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out
    return schedule


def make_schedule(cfg: TrainConfig, total_steps: int
                  ) -> Callable[[int], float]:
    """Learning rate as a function of the update count (from 0)."""
    warmup = max(int(total_steps * cfg.warmup_ratio), 0)
    if cfg.lr_schedule == "cosine":
        w, decay = max(warmup, 1), max(total_steps, 2)
        return _join([_linear(0.0, cfg.learning_rate, w),
                      _cosine(cfg.learning_rate, decay - w)], [w])
    if cfg.lr_schedule == "linear":
        return _join([_linear(0.0, cfg.learning_rate, max(warmup, 1)),
                      _linear(cfg.learning_rate, 0.0,
                              max(total_steps - warmup, 1))], [warmup])
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    raise ValueError(cfg.lr_schedule)


@dataclasses.dataclass
class OptState:
    """What optax keeps for ``chain(clip_by_global_norm, adamw)``: the
    update count (``ScaleByAdamState.count``, equal to the schedule's) and
    the fp32 moments ``mu``, ``nu`` (trees like the parameters); with
    ``grad_accum > 1`` also ``MultiSteps``' ``mini_step``,
    ``gradient_step`` and the running mean ``acc_grads``."""

    count: int
    mu: dict
    nu: dict
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: dict | None = None


class AdamW:
    """Clip by global norm, then AdamW, optionally inside MultiSteps."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 max_grad_norm: float, grad_accum: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.grad_accum = grad_accum

    def init(self, params) -> OptState:
        def zeros(tree):
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            tree)
        return OptState(count=0, mu=zeros(params), nu=zeros(params),
                        acc_grads=zeros(params) if self.grad_accum > 1
                        else None)

    @torch.no_grad()
    def update(self, grads, state: OptState, params) -> None:
        """One call with this (micro-)step's gradients: updates ``params``
        and ``state`` in place."""
        k = self.grad_accum
        if k <= 1:
            self._apply(grads, state, params)
            return
        n = state.mini_step
        for a, g in zip(tree_leaves(state.acc_grads), tree_leaves(grads)):
            a.copy_(a + (g - a) / (n + 1))
        if n == k - 1:
            self._apply(state.acc_grads, state, params)
            for a in tree_leaves(state.acc_grads):
                a.zero_()
            state.gradient_step += 1
        state.mini_step = (n + 1) % k

    def _apply(self, grads, state: OptState, params) -> None:
        norm = global_norm(grads)
        clip = norm >= self.max_grad_norm  # stays on the device: no sync
        count = state.count + 1
        # host scalars, rounded to fp32 as optax's are (a tensor operand
        # times a Python float computes in the tensor's fp32)
        lr = _f32(-self.schedule(state.count))
        bc1 = _f32(1 - _f32(self.b1) ** count)
        bc2 = _f32(1 - _f32(self.b2) ** count)
        b1, b2 = self.b1, self.b2
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            g = torch.where(clip, (g / norm) * self.max_grad_norm, g)
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + lr * u)
        state.count = count


def make_optimizer(cfg: TrainConfig, total_steps: int) -> AdamW:
    """The JAX package's optimizer: clip, AdamW with ``make_schedule``,
    MultiSteps over ``cfg.grad_accum`` micro-steps."""
    return AdamW(make_schedule(cfg, total_steps), b1=cfg.adam_b1,
                 b2=cfg.adam_b2, eps=cfg.adam_eps,
                 weight_decay=cfg.weight_decay,
                 max_grad_norm=cfg.max_grad_norm, grad_accum=cfg.grad_accum)
