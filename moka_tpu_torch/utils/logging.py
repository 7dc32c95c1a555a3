"""Metrics logging and parameter reports (port of
``moka_tpu/utils/logging.py``).

Stdout lines (``[step N] loss=...``), a JSONL metrics stream
(``metrics.jsonl``) and, when asked, TensorBoard events through
``torch.utils.tensorboard`` (dropped quietly when it does not import, as
the JAX package drops its tensorflow writer).  ``param_report`` writes the
same text as the JAX package's, so ``model_trainable_params.txt`` is one
file in both.
"""

from __future__ import annotations

import json
import math
import os


def _flatten_with_path(tree, path: str = ""):
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``
    order and ``keystr`` form: dict keys sorted, ``['key']`` for a dict
    entry, ``[i]`` for a list or tuple item; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten_with_path(t, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def param_count(tree) -> int:
    return sum(math.prod(getattr(x, "shape", ()))
               for _, x in _flatten_with_path(tree))


def param_report(tree) -> str:
    """Name/shape/count dump a la ``model_trainable_params.txt``."""
    lines = []
    total = 0
    for path, leaf in _flatten_with_path(tree):
        shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
        n = math.prod(shape) if hasattr(leaf, "shape") else 0
        total += n
        lines.append(f"{path}  {shape}  {n}")
    lines.append(f"TOTAL trainable params: {total}")
    return "\n".join(lines)


class MetricsLogger:
    def __init__(self, out_dir: str, enabled: bool = True,
                 tensorboard: bool = False):
        self.enabled = enabled
        self._jsonl = None
        self._tb = None
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
                except Exception:
                    self._tb = None

    def log(self, step: int, metrics: dict) -> None:
        if not self.enabled:
            return
        clean = {k: (float(v) if not isinstance(v, (str, int)) else v)
                 for k, v in metrics.items()}
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in clean.items())
        print(f"[step {step}] {line}", flush=True)
        self._jsonl.write(json.dumps({"step": step, **clean}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                if isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
