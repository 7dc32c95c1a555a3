"""Training loop (port of ``moka_tpu/train/trainer.py``).

Per-step metrics (stdout and ``metrics.jsonl``), periodic checkpoints with
auto-resume, the final split torch export, the config snapshot
(``saved_config.json``), the trainable-parameter report
(``model_trainable_params.txt``), the modality-grouped samplers, the
AdaLoRA rank schedule, an eval hook, and ``torch.profiler`` tracing of a
window of steps (a Chrome trace under ``out_dir/trace``).

Only the main process (``torch.distributed`` rank 0, or the only process)
logs and writes files; every rank waits at a barrier around a save.  With
a ``mesh`` the step sums the ranks' losses and gradients
(``train.step.make_train_step``), so the logged loss is the global one.  After a resume, ``train`` reads the batch iterator from its
start and trains until the total step count, as the JAX trainer does: it
does not skip the batches the restored steps consumed.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from moka_tpu_torch.core.config import TrainConfig, dump_config
from moka_tpu_torch.core.rng import DropoutKey
from moka_tpu_torch.parallel.mesh import process_rank
from moka_tpu_torch.train import checkpoint as ckpt
from moka_tpu_torch.train.optim import make_optimizer
from moka_tpu_torch.train.step import init_train_state, make_train_step
from moka_tpu_torch.utils.logging import MetricsLogger, param_report


def grouped_indices(lengths: list[int], group_key: list,
                    batch_size: int, seed: int,
                    drop_remainder: bool = False) -> list[int]:
    """Modality/length-grouped shuffle: shuffle within modality groups,
    emit batches of same-group samples in random batch order.

    drop_remainder=True drops each group's ragged tail so every consecutive
    ``batch_size`` chunk of the flattened order is single-group (required
    when the caller re-chunks the flat list)."""
    rng = np.random.default_rng(seed)
    groups: dict = {}
    for i, key in enumerate(group_key):
        groups.setdefault(key, []).append(i)
    batches = []
    for idxs in groups.values():
        idxs = list(rng.permutation(idxs))
        # length-sorted megabatches for padding efficiency
        idxs.sort(key=lambda i: lengths[i])
        group_batches = [idxs[i:i + batch_size]
                         for i in range(0, len(idxs), batch_size)]
        if drop_remainder and group_batches and \
                len(group_batches[-1]) < batch_size:
            group_batches.pop()
        batches.extend(group_batches)
    rng.shuffle(batches)
    return [i for b in batches for i in b]


def host_sharded_order(lengths: list[int], group_key: list,
                       global_batch: int, rank: int, world: int,
                       seed: int) -> list[int]:
    """Data sharding without a sampler service: every process draws the
    SAME global grouped order (same seed), then keeps only its stride of
    each global batch.  The union of the processes' slices is exactly the
    global order and the slices are disjoint."""
    per_host = global_batch // world
    order = grouped_indices(lengths, group_key, global_batch, seed=seed,
                            drop_remainder=True)
    return [int(j) for i in
            range(0, len(order) - global_batch + 1, global_batch)
            for j in order[i + rank * per_host: i + (rank + 1) * per_host]]


def _sync(t) -> None:
    if torch.is_tensor(t) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Trainer:
    def __init__(self, loss_fn: Callable, trainable, frozen,
                 cfg: TrainConfig, total_steps: int,
                 full_config=None, mesh=None):
        self.cfg = cfg
        self.frozen = frozen
        self.tx = make_optimizer(cfg, total_steps)
        taps = None
        if cfg.adalora_budget > 0:
            from moka_tpu_torch.adapters.peft import adalora_grad_taps
            taps = adalora_grad_taps
        self.step_fn = make_train_step(loss_fn, self.tx, grad_taps=taps,
                                       mesh=mesh)
        self.state = init_train_state(trainable, self.tx,
                                      DropoutKey(cfg.seed))
        self.total_steps = total_steps
        # a fractional save_every_steps is a fraction of the total steps
        self.save_every = cfg.save_every_steps
        if 0 < self.save_every < 1:
            self.save_every = max(int(total_steps * self.save_every), 1)
        self.save_every = int(self.save_every)
        self.out_dir = cfg.output_dir
        self.is_main = process_rank() == 0
        if self.is_main:
            os.makedirs(self.out_dir, exist_ok=True)
            dump_config(full_config if full_config is not None else cfg,
                        os.path.join(self.out_dir, "saved_config.json"))
            with open(os.path.join(self.out_dir,
                                   "model_trainable_params.txt"), "w") as f:
                f.write(param_report(trainable))
        self.logger = MetricsLogger(self.out_dir, enabled=self.is_main)
        self._maybe_resume()

    def _maybe_resume(self) -> None:
        ckpt_dir = os.path.join(self.out_dir, "checkpoints")
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            self.state = ckpt.restore(ckpt_dir, self.state)
            if self.is_main:
                print(f"[trainer] resumed from step {last}", flush=True)

    def train(self, batches: Iterable[dict],
              profile_steps: tuple[int, int] | None = None,
              eval_fn: Callable | None = None,
              eval_every_steps: int = 0):
        """eval_fn(state) -> metrics dict, run every ``eval_every_steps``;
        ``profile_steps`` (start, stop): trace the steps in between."""
        t0 = time.perf_counter()
        prof = None
        for batch in batches:
            step = int(self.state.step)
            if step >= self.total_steps:
                break
            if profile_steps and step == profile_steps[0] and self.is_main:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if torch.cuda.is_available() else [])])
                prof.start()
            self.state, metrics = self.step_fn(self.state, self.frozen,
                                               batch)
            step += 1
            taps = metrics.pop("grad_taps", None)
            if taps is not None and \
                    step % self.cfg.adalora_update_every == 0:
                # the AdaLoRA schedule step: re-allocate the global rank
                # budget from this step's sensitivity scores
                from moka_tpu_torch.adapters.peft import adalora_update_masks
                self.state = dataclasses.replace(
                    self.state, params=adalora_update_masks(
                        self.state.params, taps, self.cfg.adalora_budget))
            if prof is not None and step == profile_steps[1]:
                _sync(metrics["loss"])
                prof.stop()
                trace_dir = os.path.join(self.out_dir, "trace")
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    trace_dir, f"steps_{profile_steps[0]}_{step}.json"))
                prof = None
            if step % self.cfg.log_every == 0:
                # in sorted-key order, as the JAX step's jitted dict
                metrics = {k: float(metrics[k]) for k in sorted(metrics)}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                metrics["step_time_s"] = dt / self.cfg.log_every
                self.logger.log(step, metrics)
            if eval_fn is not None and eval_every_steps and \
                    step % eval_every_steps == 0:
                em = {f"eval_{k}": float(v)
                      for k, v in eval_fn(self.state).items()}
                self.logger.log(step, em)
            if self.save_every and step % self.save_every == 0:
                ckpt.save_on_main(os.path.join(self.out_dir, "checkpoints"),
                                  self.state)
        if prof is not None:
            prof.stop()
        return self.state

    def finalize(self, stage1: bool = False) -> None:
        """The final split save (``adapter_model.bin`` +
        ``non_lora_trainables.bin``) and a last checkpoint.  ``stage1``
        selects the reference's stage-1 (unwrapped ``model.``) key
        prefixes."""
        ckpt.save_on_main(os.path.join(self.out_dir, "checkpoints"),
                          self.state)
        if self.is_main:
            ckpt.export_torch_artifacts(self.out_dir, self.state.params,
                                        stage1=stage1)
            self.logger.close()
        ckpt.barrier()
