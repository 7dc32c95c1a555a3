#!/usr/bin/env python3
"""Where the port's time goes on one card: ``torch.profiler`` around
chip_smoke's serving main path, ``greedy_generate`` of LLaMA-2-7B + MokA
AVT r=4 (bf16 base, random weights from a seed, B non-zero), and around
one step of each of its training paths (``make_train_step`` at b 4,
L 1024: full remat, fused dropout under ``proj_lse``, and the quantized
recipe's route B: int4 base, int8 head through the fused CE kernels,
``a8_dots="full"``, ``save_q8``, ``proj_lse``, full remat with the
flash rank attention, and the multimodal step of phase 13 with the
encoders' pass of phase 12's batch), at chip_smoke's shapes.

    python3 profile_port.py              # every window, one card
    python3 profile_port.py mm quant     # only the windows named

Serving, two windows: ``greedy_generate`` for one new token (the prefill
and the head on its last row, no decode step) and for NEW_TOKENS (the main
path).  The decode steps are the second window less the first, per device
operation.  Training, one window: one step after two warm-up steps.  For
each it prints the wall time untraced (measured before any tracing) and
traced (host clock around work that ends in a synchronise), the device
busy time (the sum of kernel and copy self times on the card, so busy /
traced wall is the device's busy share), the device operations launched,
and the largest entries by device self time.  The last line is one JSON
object with those numbers and the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, PROMPT, NEW_TOKENS = 8, 896, 32  # chip_smoke's main path
TRAIN_BATCH, TRAIN_LEN = 4, 1024        # chip_smoke's training step
TOP = 16


def _self_us(e) -> float:
    return float(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0))


def wall_ms(fn) -> float:
    """Host-clock ms of ``fn`` after one warm-up, ending in a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def trace(fn) -> tuple[float, dict, dict]:
    """(traced wall ms, {device entry: (count, self µs)}, {host entry:
    (count, self CPU µs)}) of one run of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    ops = {e.key: (e.count, _self_us(e)) for e in events
           if e.device_type == cuda}
    host = {e.key: (e.count, float(e.self_cpu_time_total)) for e in events
            if e.device_type != cuda and e.self_cpu_time_total > 0}
    return traced, ops, host


GROUPS = (  # device entries by name, first match wins
    ("flash kernels (port)", ("flash_fwd_kernel", "flash_bwd_")),
    ("flash rank kernels (port)", ("flash_rank_",)),
    ("fused MokA kernels (port)", ("moka_delta_kernel",
                                   "question_keys_kernel")),
    ("fused dropout kernels (port)", ("dropout_a_fwd_kernel",
                                      "dropout_a_bwd_kernel",
                                      "sum_tiles_kernel")),
    ("fused CE kernels (port)", ("fused_ce_",)),
    ("int8 GEMMs (cuBLASLt, torch._int_mm)", ("imma", "i8i8", "s8", "int8")),
    ("bf16 GEMMs (cuBLAS)", ("nvjet",)),
    ("fp32 GEMMs and GEMVs (cuBLAS, CUTLASS SIMT)", ("gemm_f32", "sgemm",
                                                     "gemv", "splitK")),
    ("dropout bits (randint)", ("distribution_elementwise",)),
    ("copies and casts", ("copy",)),
    ("other elementwise and reductions", ("",)),
)


def groups(ops) -> dict:
    """Device self time (ms) summed by GROUPS."""
    out = {g: 0.0 for g, _ in GROUPS}
    for key, (_, us) in ops.items():
        g = next(g for g, pats in GROUPS if any(p in key for p in pats))
        out[g] += us / 1e3
    return out


def summary(name, wall, traced, ops, per=1, host=None) -> dict:
    """Print and return a window's numbers, divided by ``per``; with
    ``host``, also the largest host entries by self CPU time."""
    busy = sum(us for _, us in ops.values()) / 1e3
    n_ops = sum(c for c, _ in ops.values())
    print(f"== {name}: wall {wall / per:.3f} ms untraced, {traced / per:.3f}"
          f" ms traced; device busy {busy / per:.3f} ms "
          f"({100 * busy / traced:.1f}% of traced wall); "
          f"{n_ops / per:.0f} device operations", flush=True)
    rows = []
    for key, (count, us) in sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]:
        rows.append({"name": key[:90], "count": count / per,
                     "ms": us / 1e3 / per})
        print(f"  {us / 1e3 / per:10.3f} ms {count / per:8.1f}x  {key[:90]}",
              flush=True)
    by_group = {g: ms / per for g, ms in groups(ops).items()}
    print("  by group: " + "; ".join(f"{g} {ms:.3f} ms"
                                     for g, ms in by_group.items()),
          flush=True)
    out = {"wall_ms": wall / per, "traced_ms": traced / per,
           "busy_ms": busy / per, "busy_share": busy / traced,
           "device_ops": n_ops / per, "top": rows, "groups": by_group}
    if host is not None:
        total = sum(us for _, us in host.values()) / 1e3
        print(f"  host, by self CPU time (traced; {total:.1f} ms in all):",
              flush=True)
        out["host_top"] = []
        for key, (count, us) in sorted(host.items(),
                                       key=lambda kv: -kv[1][1])[:TOP]:
            out["host_top"].append({"name": key[:90], "count": count,
                                    "ms": us / 1e3})
            print(f"  {us / 1e3:10.3f} ms {count:8d}x  {key[:90]}",
                  flush=True)
    return out


WINDOWS = ("serving", "full", "fused", "quant", "rank", "mm")
TRAIN_KEYS = {"full": "train_step", "fused": "train_step_fused_proj_lse",
              "quant": "train_step_quant_route_b",
              "rank": "train_step_flash_rank", "mm": "train_step_multimodal"}


def main(argv=None) -> int:
    import torch
    names = list(argv or sys.argv[1:]) or list(WINDOWS)
    if set(names) - set(WINDOWS):
        print(f"profile_port: windows are {WINDOWS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from moka_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build()
    out = {"card": smi}
    if "serving" in names:
        out.update(serving_windows())
    for path in names:
        if path != "serving":
            out.update(train_window(path))
            gc.collect()
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def serving_windows() -> dict:
    """``greedy_generate`` for one and NEW_TOKENS new tokens, and the
    decode steps as their difference."""
    from chip_smoke import build_model, generate, main_path_inputs
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.ops.moka import MokaSpec
    cfg = LlamaConfig.llama2_7b()
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    base, adapters = build_model(cfg, spec)
    inputs = main_path_inputs(cfg, base, BATCH, PROMPT)
    return generate_windows(
        lambda n: generate(cfg, spec, base, adapters, inputs, n),
        f"greedy_generate b {BATCH} L {PROMPT}")


def generate_windows(gen, what: str, prefix: str = "") -> dict:
    """``gen(1)`` (the prefill and the head on its last row) and
    ``gen(NEW_TOKENS)``, untraced and traced, and the decode steps as
    their difference, per device operation."""
    import torch
    with torch.inference_mode():
        # untraced walls first: after a profiler session launches cost
        # more on the host, which would inflate a later untraced wall
        w1, wn = wall_ms(lambda: gen(1)), wall_ms(lambda: gen(NEW_TOKENS))
        (t1, ops1, _), (tn, opsn, _) = (trace(lambda: gen(1)),
                                        trace(lambda: gen(NEW_TOKENS)))
    steps = NEW_TOKENS - 1
    decode_ops = {}
    for key, (count, us) in opsn.items():
        c1, us1 = ops1.get(key, (0, 0.0))
        if count > c1:
            decode_ops[key] = (count - c1, us - us1)
    return {prefix + "prefill": summary(f"{what}, 1 new token", w1, t1,
                                        ops1),
            prefix + "main_path": summary(f"{what}, {NEW_TOKENS} new tokens",
                                          wn, tn, opsn),
            prefix + "decode_step": summary(
                f"decode, a step ({steps} steps: the second window less the "
                f"first)", wn - w1, tn - t1, decode_ops, per=steps)}


def mm_stack():
    """chip_smoke's phases 12-13 stack: the int4 base (int8 head),
    adapters, int8 towers and projectors, and its config."""
    from chip_smoke import (build_mm_stack, build_quant_trainer, mm_config,
                            quant_train_config)
    ucfg = mm_config()
    frozen, trainable = build_quant_trainer(*quant_train_config())
    return ucfg, *build_mm_stack(ucfg, frozen, trainable["adapters"])


def train_window(path: str = "full") -> dict:
    """One ``make_train_step`` step of a chip_smoke training path after two
    warm-up steps, untraced first, then traced: "full" (phase 6, full
    remat), "fused" (phase 8: fused dropout under ``proj_lse``), "quant"
    (phase 9, route B: the quantized recipe with ``pallas_ce``), "rank"
    (phase 11: phase 6's step with the flash rank attention) or "mm"
    (phase 13, the multimodal step; first phase 12's ``unified.generate``
    windows and the encoders' pass, ``build_inputs_embeds``, alone)."""
    import torch
    from chip_smoke import (QUANT_RECIPE, build_quant_trainer,
                            build_trainer, fused_train_config, mm_batch,
                            mm_loss, quant_train_config, rank_train_config,
                            train_batch, train_config, train_loss)
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.models import unified
    from moka_tpu_torch.train.optim import make_optimizer
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    out = {}
    tx = make_optimizer(TrainConfig(), total_steps=1000)
    if path == "mm":
        ucfg, frozen, trainable = mm_stack()
        prompts = mm_batch(ucfg, BATCH)

        def encode():
            return unified.build_inputs_embeds(trainable, frozen, ucfg,
                                               prompts)

        with torch.inference_mode():
            wall = wall_ms(encode)
            traced, ops, host = trace(encode)
        out["multimodal_encode"] = summary(
            f"build_inputs_embeds b {BATCH} (CLIP, BEATs, projectors, "
            f"splice: phase 12's prompts)", wall, traced, ops, host=host)
        out.update(generate_windows(
            lambda n: unified.generate(trainable, frozen, ucfg, prompts,
                                       max_new_tokens=n, eos_id=-1),
            f"unified.generate b {BATCH} (phase 12)", "multimodal_"))
        del prompts
        batch = mm_batch(ucfg, TRAIN_BATCH, TRAIN_LEN)
        step = make_train_step(mm_loss(ucfg, True), tx)
    else:
        quant = dict(QUANT_RECIPE, pallas_ce=True) if path == "quant" \
            else {}
        cfg, spec = {"full": train_config, "fused": fused_train_config,
                     "quant": quant_train_config,
                     "rank": rank_train_config}[path]()
        policy = None if path in ("full", "rank") else "proj_lse"
        frozen, trainable = (build_quant_trainer if quant else
                             build_trainer)(cfg, spec)
        batch = train_batch(cfg, TRAIN_BATCH, TRAIN_LEN)
        step = make_train_step(train_loss(cfg, spec, True, policy, **quant),
                               tx)
    state = init_train_state(trainable, tx, DropoutKey(0))

    def one():
        nonlocal state
        state, m = step(state, frozen, batch)
        float(m["loss"])

    one()
    wall = wall_ms(one)  # a warm-up step, then the untraced one
    traced, ops, host = trace(one)
    what = {"full": "full remat", "fused": "fused dropout, proj_lse",
            "quant": "int4 base, a8 full, save_q8, proj_lse, fused CE",
            "rank": "full remat, flash rank attention",
            "mm": "multimodal: int8 towers, projectors, int4 base, a8 "
                  "full, qkvod_lse"}[path]
    out[TRAIN_KEYS[path]] = summary(
        f"training step b {TRAIN_BATCH} L {TRAIN_LEN} (make_train_step, "
        f"{what})", wall, traced, ops, host=host)
    return out


if __name__ == "__main__":
    sys.exit(main())
