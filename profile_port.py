#!/usr/bin/env python3
"""Where the port's serving time goes on one card: ``torch.profiler``
around chip_smoke's main path, ``greedy_generate`` of LLaMA-2-7B + MokA
AVT r=4 (bf16 base, random weights from a seed, B non-zero) at its shapes.

    python3 profile_port.py        # from the root of a checkout, one card

Two windows: ``greedy_generate`` for one new token (the prefill and the
head on its last row, no decode step) and for NEW_TOKENS (the main path).
The decode steps are the second window less the first, per device
operation.  For each it prints the wall time untraced (measured before any
tracing) and traced (host clock around work that ends in a synchronise),
the device busy time (the sum of kernel and copy self times on the card,
so busy / traced wall is the device's busy share), the device operations
launched, and the largest entries by device self time.  The last line is one JSON object with those
numbers and the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, PROMPT, NEW_TOKENS = 8, 896, 32  # chip_smoke's main path
TOP = 12


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


def trace(fn) -> tuple[float, dict]:
    """(traced wall ms, {device entry: (count, self µs)}) of one run of
    ``fn``."""
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
    ops = {e.key: (e.count, _self_us(e)) for e in prof.key_averages()
           if e.device_type == cuda}
    return traced, ops


def summary(name, wall, traced, ops, per=1) -> dict:
    """Print and return a window's numbers, divided by ``per``."""
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
    return {"wall_ms": wall / per, "traced_ms": traced / per,
            "busy_ms": busy / per, "busy_share": busy / traced,
            "device_ops": n_ops / per, "top": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import build_model, generate, main_path_inputs
    from moka_tpu_torch import kernels
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.ops.moka import MokaSpec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build()
    cfg = LlamaConfig.llama2_7b()
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    base, adapters = build_model(cfg, spec)
    inputs = main_path_inputs(cfg, base, BATCH, PROMPT)

    def one():
        return generate(cfg, spec, base, adapters, inputs, 1)

    def all_tokens():
        return generate(cfg, spec, base, adapters, inputs, NEW_TOKENS)

    with torch.inference_mode():
        # untraced walls first: after a profiler session launches cost
        # more on the host, which would inflate a later untraced wall
        w1, wn = wall_ms(one), wall_ms(all_tokens)
        (t1, ops1), (tn, opsn) = trace(one), trace(all_tokens)
    steps = NEW_TOKENS - 1
    decode_ops = {}
    for key, (count, us) in opsn.items():
        c1, us1 = ops1.get(key, (0, 0.0))
        if count > c1:
            decode_ops[key] = (count - c1, us - us1)
    out = {"card": smi,
           "prefill": summary(f"prefill (greedy_generate, 1 new token) b "
                              f"{BATCH} L {PROMPT}", w1, t1, ops1),
           "main_path": summary(f"greedy_generate b {BATCH} L {PROMPT}, "
                                f"{NEW_TOKENS} new tokens", wn, tn, opsn),
           "decode_step": summary(f"decode, a step ({steps} steps: the "
                                  f"second window less the first)",
                                  wn - w1, tn - t1, decode_ops, per=steps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
