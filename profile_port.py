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
    python3 profile_port.py flash --root DIR   # another checkout's kernels

``flash`` (not among the default windows) times the query-major flash
kernels through their wrappers at chip_smoke's shapes: kernel 1 at the
serving prefill and at the CLIP tower's 80 and 40 frames, kernel 3 at the
long-context step's: device ms a call (CUDA events) and the wrapper's host
µs a call (launches enqueued back to back).  ``--root DIR`` imports
``moka_tpu_torch`` from the checkout at DIR (built into DIR/build), so two
versions compare on one card in one call.  ``flash_ablation`` times kernel
1 with parts taken out (FLASH_ABLATIONS: edited copies of its source built
under build/), at the prefill and CLIP shapes: where its time goes.

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
FLASH_CASES = {  # name: (b, L, S, H, hd, causal), chip_smoke's shapes
    "flash_fwd": (8, 896, 928, 32, 128, True),
    "flash_fwd_hd64 80 frames": (80, 257, 257, 16, 64, False),
    "flash_fwd_hd64 40 frames": (40, 257, 257, 16, 64, False),
    "flash_bwd_dq": (1, 4096, 4096, 32, 128, True)}


_IDLE = ("        } else if (kv_w - k0 <= NARROW) {",
         "        } else if (true) {\n        } else if (kv_w - k0 <= NARROW) {")
FLASH_ABLATIONS = {  # name: edits (old text, new text) of flash_fwd.cu with
    "kernel": [],    # hopper.cuh inlined; the edited kernels' outputs are
    "no softmax exp2 (P = S)": [  # wrong, only their times are read
        ("const float p0 = exp2_approx(sc[i] - mx[u]);",
         "const float p0 = sc[i];"),
        ("const float p1 = exp2_approx(sc[i + 1] - mx[u]);",
         "const float p1 = sc[i + 1];")],
    "no P V": [("  for (int kk = 0; kk < N / 16; ++kk)",
                "  for (int kk = 0; kk < 0; ++kk)")],
    "no S": [("  for (int kk = 0; kk < HD / 16; ++kk) {",
              "  for (int kk = 0; kk < 0; ++kk) {")],
    "consumers idle (the loads alone)": [_IDLE],
    "consumers idle, K without V": [
        _IDLE, ("mbar_arrive_expect_tx(full, 2 * C::KV_TILE);",
                "mbar_arrive_expect_tx(full, C::KV_TILE);"),
        ("              tma_load_4d(base + C::OFF_V + s * C::KV_TILE + half "
         "* 2 * BOX,\n                          &tm_v, full, 64 * half, kh, "
         "k0, b, l2_evict_last());", "")],
    "consumers idle, 1 K/V stage": [
        _IDLE, ("static constexpr int STAGES = 2;",
                "static constexpr int STAGES = 1;")],
    "consumers idle, half the CTAs": [
        _IDLE, ("const int ctas = sm_count() * C::MIN_CTAS;",
                "const int ctas = sm_count() * C::MIN_CTAS / 2;")],
    "consumers idle, no L2 hints": [
        _IDLE, ("L2::evict_first.b64", "L2::evict_normal.b64"),
        ("L2::evict_last.b64", "L2::evict_normal.b64")]}


def ablation_source(edits, csrc: Path) -> str:
    """flash_fwd.cu with hopper.cuh inlined and ``edits`` applied; raises
    if an edit's old text is not in the source."""
    src = (csrc / "flash_fwd.cu").read_text().replace(
        '#include "hopper.cuh"', (csrc / "hopper.cuh").read_text())
    for old, new in edits:
        if old not in src:
            raise ValueError(f"ablation edit no longer applies: {old!r}")
        src = src.replace(old, new)
    return src


def flash_ablation_window(iters: int = 20) -> dict:
    """Kernel 1 with parts taken out (FLASH_ABLATIONS), each built by nvcc
    (all at once) and launched through the wrapper in place of the
    library, timed like ``flash_window`` at its prefill and CLIP (80
    frames) shapes, twice in turn."""
    import ctypes
    import torch
    from moka_tpu_torch import kernels
    from moka_tpu_torch.ops import flash_attention as fa
    out_dir = kernels.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(FLASH_ABLATIONS.items()):
        src = out_dir / f"v{i}.cu"
        src.write_text(ablation_source(edits, kernels.CSRC))
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT),
            src.with_suffix(".so"))
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for ablation {name!r}")
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.moka_flash_fwd.argtypes = [p] * 6 + [i] * 8 + [f, p]
        lib.moka_flash_fwd.restype = i
        libs[name] = lib
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name in ("flash_fwd", "flash_fwd_hd64 80 frames"):
        b, L, S, H, hd, causal = FLASH_CASES[name]
        q, k, v = (torch.randn((b, n, H, hd), generator=g,
                               device="cuda").bfloat16() for n in (L, S, S))
        cases[name] = (q, k, v, torch.ones((b, S), dtype=torch.int32,
                                           device="cuda"), causal)
    kept = fa._libs.get("flash_fwd")
    out = {name: {} for name in FLASH_ABLATIONS}
    try:
        for _ in range(2):
            for name, lib in libs.items():
                fa._libs["flash_fwd"] = lib
                for case, (q, k, v, mask, causal) in cases.items():
                    def call():
                        fa.flash_fwd(q, k, v, mask, 0, causal)
                    for _ in range(3):
                        call()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(iters):
                        call()
                    end.record()
                    end.synchronize()
                    out[name].setdefault(case, []).append(
                        start.elapsed_time(end) / iters)
    finally:
        if kept is None:
            fa._libs.pop("flash_fwd", None)
        else:
            fa._libs["flash_fwd"] = kept
    for name, times in out.items():
        print(f"  {name}: " + ", ".join(
            f"{case} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for case, ts in times.items()), flush=True)
    return {"flash_ablation": out}


def flash_window(iters: int = 20, host_calls: int = 50) -> dict:
    """Device ms a call (CUDA events over ``iters`` calls after 3 warm-up
    calls) and host µs a call (``host_calls`` calls enqueued back to back,
    host clock, before one synchronise) of each FLASH_CASES kernel through
    its wrapper, every key valid, q_offset 0."""
    import torch
    from moka_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"package": fa.__file__}
    for name, (b, L, S, H, hd, causal) in FLASH_CASES.items():
        q, k, v, dout = (torch.randn((b, n, H, hd), generator=g,
                                     device="cuda").bfloat16()
                         for n in (L, S, S, L))
        mask = torch.ones((b, S), dtype=torch.int32, device="cuda")
        if name == "flash_bwd_dq":
            o, lse = fa.flash_fwd(q, k, v, mask, 0, causal)
            delta = (dout.float() * o.float()).sum(-1).transpose(1, 2) \
                .contiguous()

            def call():
                fa.flash_bwd_dq(q, k, v, mask, dout, lse, delta, 0, causal)
        else:
            def call():
                fa.flash_fwd(q, k, v, mask, 0, causal)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        t0 = time.perf_counter()
        for _ in range(host_calls):
            call()
        host_us = (time.perf_counter() - t0) / host_calls * 1e6
        torch.cuda.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / iters,
                     "host_us": host_us}
        print(f"  {name}: {out[name]['ms']:.4f} ms a call, host "
              f"{host_us:.1f} us a call", flush=True)
    return {"flash": out}
TRAIN_KEYS = {"full": "train_step", "fused": "train_step_fused_proj_lse",
              "quant": "train_step_quant_route_b",
              "rank": "train_step_flash_rank", "mm": "train_step_multimodal"}


def main(argv=None) -> int:
    import torch
    names = list(argv or sys.argv[1:]) or list(WINDOWS)
    root = ROOT
    if "--root" in names:
        i = names.index("--root")
        root = Path(names[i + 1]).resolve()
        del names[i:i + 2]
    if set(names) - {*WINDOWS, "flash", "flash_ablation"}:
        print(f"profile_port: windows are {WINDOWS}, flash and "
              f"flash_ablation", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from moka_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build()
    out = {"card": smi}
    if "flash" in names:
        out.update(flash_window())
    if "flash_ablation" in names:
        out.update(flash_ablation_window())
    if "serving" in names:
        out.update(serving_windows())
    for path in names:
        if path not in ("serving", "flash", "flash_ablation"):
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
