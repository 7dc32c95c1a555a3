"""Distributed batched inference (port of ``moka_tpu/eval/runner.py``).

Reference: ``AudioVisualText/scripts/finetune/inference_cut.py`` — DDP wrap
+ ``Test_DistributedSampler`` (strided rank sharding WITHOUT wrap-padding,
:32-50, so no duplicate predictions), batched greedy generate, per-rank
JSONL shards merged by the scorers.

Here: index sharding strided by the ``torch.distributed`` rank (rank 0 of
1 without an initialized group); each process runs generate on its shard
and writes ``result_rank{r}_{task}.jsonl``."""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Sequence


def shard_indices(n: int, rank: int, world: int) -> list[int]:
    """Strided, no padding duplicates (inference_cut.py:32-50)."""
    return list(range(rank, n, world))


def batched(seq: Sequence, batch_size: int) -> Iterable[list]:
    buf = []
    for x in seq:
        buf.append(x)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def write_jsonl(path: str, rows: Iterable[dict], mode: str = "a") -> None:
    with open(path, mode) as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def run_inference(dataset, generate_fn: Callable[[list], list[dict]],
                  out_dir: str, task: str, batch_size: int = 8,
                  rank: int | None = None, world: int | None = None) -> str:
    """generate_fn(items) -> list of result dicts (one per item)."""
    if rank is None or world is None:
        import torch.distributed as dist
        group = dist.is_available() and dist.is_initialized()
        if rank is None:
            rank = dist.get_rank() if group else 0
        if world is None:
            world = dist.get_world_size() if group else 1
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"result_rank{rank}_{task}.jsonl")
    if os.path.exists(out_path):
        os.remove(out_path)
    idxs = shard_indices(len(dataset), rank, world)
    for chunk in batched(idxs, batch_size):
        items = [dataset[i] for i in chunk]
        write_jsonl(out_path, generate_fn(items))
    return out_path
