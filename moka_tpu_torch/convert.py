"""Parameter trees from numpy to the port's tensors.

The JAX package and the port share one parameter layout (layer-stacked
dicts of ``(d_in, d_out)`` matrices, ``{"a", "b"}`` adapter pairs), so a
tree taken out of JAX as numpy arrays (``jax.tree.map(np.asarray, tree)``)
converts leaf by leaf with no renaming.  A mask bundle (any object with
``modality`` and ``question`` fields) becomes the port's ``MaskBundle``.
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
