"""Parameter trees from numpy to the port's tensors.

The JAX package and the port share one parameter layout (layer-stacked
dicts of ``(d_in, d_out)`` matrices, ``{"a", "b"}`` adapter pairs), so a
tree taken out of JAX as numpy arrays (``jax.tree.map(np.asarray, tree)``)
converts leaf by leaf with no renaming.  A mask bundle (any object with
``modality`` and ``question`` fields) becomes the port's ``MaskBundle``.
``train_state_from_numpy`` carries a JAX training state across (params,
AdamW moments and counts, the step), so a run can resume in the port.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: arrays out of JAX are read-only
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """Convert a tree of numpy arrays (dicts, lists, tuples, mask bundles)
    to tensors on ``device``; floating leaves are cast to ``dtype`` when it
    is given, integer leaves keep their type.  Python scalars pass
    through."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    if hasattr(tree, "modality") and hasattr(tree, "question"):
        from moka_tpu_torch.models.llama import MaskBundle
        return MaskBundle(_tensor(tree.modality, device, dtype),
                          _tensor(tree.question, device, dtype))
    if isinstance(tree, (int, float, bool)) or tree is None:
        return tree
    return _tensor(tree, device, dtype)


def _find(tree, *fields):
    """The first node of a tree of tuples (optax states are NamedTuples)
    that has all ``fields``, or None."""
    if all(hasattr(tree, f) for f in fields):
        return tree
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _find(t, *fields)
            if found is not None:
                return found
    return None


def train_state_from_numpy(state, device, rng):
    """A JAX ``TrainState`` taken out as numpy (``jax.tree.map(np.asarray,
    state)`` with its key removed) -> the port's ``TrainState`` on
    ``device``: step, fp32 params, and from the optax state the
    ``ScaleByAdamState`` (count, mu, nu) and, when the optimizer
    accumulates gradients, ``MultiStepsState`` (mini_step, gradient_step,
    acc_grads).  JAX's key cannot be carried over: ``rng`` is the port's
    ``DropoutKey`` for the resumed run."""
    from moka_tpu_torch.train.optim import OptState
    from moka_tpu_torch.train.step import TrainState
    adam = _find(state.opt_state, "count", "mu", "nu")
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    multi = _find(state.opt_state, "mini_step", "gradient_step", "acc_grads")

    def f32(tree):
        return params_from_numpy(tree, device, torch.float32)

    opt = OptState(count=int(adam.count), mu=f32(adam.mu), nu=f32(adam.nu))
    if multi is not None:
        opt.mini_step = int(multi.mini_step)
        opt.gradient_step = int(multi.gradient_step)
        opt.acc_grads = f32(multi.acc_grads)
    return TrainState(step=int(state.step), params=f32(state.params),
                      opt_state=opt, rng=rng)
