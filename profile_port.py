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
    python3 profile_port.py fused_ce fused_ce_ablation
    python3 profile_port.py rank_kernels block_diag [--root DIR]
    python3 profile_port.py rank_ablation block_diag_ablation

``flash`` (not among the default windows) times the query-major flash
kernels through their wrappers at chip_smoke's shapes: kernel 1 at the
serving prefill and at the CLIP tower's 80 and 40 frames, kernel 3 at the
long-context step's: device ms a call (CUDA events) and the wrapper's host
µs a call (launches enqueued back to back).  ``--root DIR`` imports
``moka_tpu_torch`` from the checkout at DIR (built into DIR/build), so two
versions compare on one card in one call.  ``flash_ablation`` times kernel
1 with parts taken out (FLASH_ABLATIONS: edited copies of its source built
under build/), at the prefill and CLIP shapes: where its time goes.
``fused_ce`` times the fused CE kernels 8 and 9 through their wrappers at
route B's shape (N 4092, d 4096, V 32011, int8 head) the same way (with
``--root``, another checkout's); ``fused_ce_ablation`` times kernel 9
with parts taken out and in other tile orders (CE_ABLATIONS, edited copies
of fused_ce_bwd.cu).  ``rank_kernels`` times the three rank flash
kernels through their wrappers at chip_smoke's rank shape (b 4, L 1024,
head_dim 4, 126 question keys a sample): the kernel alone (``graph_ms``:
a CUDA graph of 100 launches, no host work between them), the host's µs a
call (``host_us``: the least of five batches) and the wrapper back to
back.  ``block_diag`` times kernel 10 at the BOFT merge's three shapes:
cold (a graph rotating over x buffers that together hold 3x the L2
cache), warm, back to back, the host's µs a call and a cold ``x.clone()``
(the same bytes moved by PyTorch's copy), then traces one BOFT merge at
phase 10's shapes (``BoftSpec(8, 2)`` on 224 random bf16 weights at
LLaMA-2-7B's widths).  Both take ``--root``.  ``rank_ablation`` and
``block_diag_ablation`` time the rank forward and kernel 10 with parts
taken out (RANK_ABLATIONS, BD_ABLATIONS: edited copies of flash_rank.cu
and block_diag.cu), twice in turn.

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
import hashlib
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
    ("block-diagonal kernel (port)", ("block_diag_kernel",)),
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


def ablation_source(edits, csrc: Path, source: str = "flash_fwd.cu") -> str:
    """``source`` (flash_fwd.cu) with hopper.cuh inlined and ``edits``
    applied; raises if an edit's old text is not in the source."""
    src = (csrc / source).read_text().replace(
        '#include "hopper.cuh"', (csrc / "hopper.cuh").read_text())
    for old, new in edits:
        if old not in src:
            raise ValueError(f"ablation edit no longer applies: {old!r}")
        src = src.replace(old, new)
    return src


def start_variants(source: str, variants: dict) -> dict:
    """Start nvcc on each variant of ``source`` (``ablation_source`` of its
    edits), all at once, under build/moka_tpu_torch/ablation/; {name:
    (process, library path)} for ``finish_variants``.  The compiler's
    lines go to a .log beside each library."""
    from moka_tpu_torch import kernels
    out_dir = kernels.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = ablation_source(edits, kernels.CSRC, source)
        # named by content: dlopen keeps the first library loaded from a path
        key = hashlib.sha256(text.encode()).hexdigest()[:16]
        src = out_dir / f"{Path(source).stem}_{key}.cu"
        src.write_text(text)
        with open(src.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                 str(kernels.CSRC), "-o", str(src.with_suffix(".so")),
                 str(src)], stdout=log, stderr=subprocess.STDOUT),
                src.with_suffix(".so"))
    return procs


def finish_variants(procs: dict, entry: str | None = None,
                    argtypes: list | None = None) -> dict:
    """Wait for ``start_variants``'s builds; {name: loaded library}, with
    ``entry`` bound to ``argtypes`` where it is given.  Prints each
    variant's register and spill lines; raises if a build failed."""
    import ctypes
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}: " +
                               so.with_suffix(".log").read_text()[-3000:])
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"    {name}: {line.strip()[:160]}", flush=True)
        lib = ctypes.CDLL(str(so))
        if entry is not None:
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_variants(source: str, ablations: dict, entry: str,
                   argtypes: list) -> dict:
    """Each variant of ``source`` (``ablation_source`` of its edits) built
    by nvcc, all at once, under build/moka_tpu_torch/ablation/; {name:
    library with ``entry`` bound to ``argtypes``}."""
    return finish_variants(start_variants(source, ablations), entry,
                           argtypes)


def event_ms(call, iters: int) -> float:
    """Device ms a call: CUDA events over ``iters`` calls after 3 warm-up
    calls."""
    import torch
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
    return start.elapsed_time(end) / iters


def graph_ms(calls, n: int = 100, reps: int = 3) -> float:
    """Device ms a call with no host work between launches: a CUDA graph
    of ``n`` calls (``calls``: one function, or several taken in turn, as
    inputs rotated past the L2 cache) replayed ``reps`` times under CUDA
    events, after one warm-up replay."""
    import torch
    calls = calls if isinstance(calls, (list, tuple)) else [calls]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del g
    torch.cuda.empty_cache()
    return ms


def host_us(fn, n: int = 200, reps: int = 5) -> float:
    """The host's µs a call of ``fn``: the least, over ``reps`` batches,
    of ``n`` calls enqueued back to back (the queue stays short of full)
    on the host clock, with a synchronise after each batch.  The least
    batch is the wrapper's own cost: the host is shared, and a slower
    batch measures its neighbours."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def flash_ablation_window(iters: int = 20) -> dict:
    """Kernel 1 with parts taken out (FLASH_ABLATIONS), each built by nvcc
    (all at once) and launched through the wrapper in place of the
    library, timed like ``flash_window`` at its prefill and CLIP (80
    frames) shapes, twice in turn."""
    import ctypes
    import torch
    from moka_tpu_torch.ops import flash_attention as fa
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = build_variants("flash_fwd.cu", FLASH_ABLATIONS, "moka_flash_fwd",
                          [p] * 6 + [i] * 8 + [f, p])
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
                    out[name].setdefault(case, []).append(event_ms(
                        lambda: fa.flash_fwd(q, k, v, mask, 0, causal),
                        iters))
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
        ms = event_ms(call, iters)
        t0 = time.perf_counter()
        for _ in range(host_calls):
            call()
        host_us = (time.perf_counter() - t0) / host_calls * 1e6
        torch.cuda.synchronize()
        out[name] = {"ms": ms, "host_us": host_us}
        print(f"  {name}: {out[name]['ms']:.4f} ms a call, host "
              f"{host_us:.1f} us a call", flush=True)
    return {"flash": out}


CE_SHAPE = (4 * 1023, 4096, 32011)  # route B's rows, d, vocab (chip_smoke)
_NO_DX = ("      for (int kk = 0; kk < TV / 16; ++kk)\n"
          "        wgmma_m64n64_rs<0>(",
          "      for (int kk = 0; kk < 0; ++kk)\n"
          "        wgmma_m64n64_rs<0>(")
_NO_LOGITS = ("      for (int kk = 0; kk < BK / 16; ++kk)\n"
              "        logits_step<",
              "      for (int kk = 0; kk < 0; ++kk)\n"
              "        logits_step<")
_NO_CONVERSION = ("      convert_stage(sm + OFF_W8",
                  "      if (false) convert_stage(sm + OFF_W8")
_SERIAL = [  # release each stage once its products are done (a ring of one)
    ("""      wgmma_commit();
      if (ks > 0) {  // the previous stage's products are done
        wgmma_wait<1>();
        mbar_arrive(empty_x + 8 * ((ix - 1) % X_STAGES));
        mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < TV / LOGITS_N; ++nb) fence_operand(acc[nb]);
    mbar_arrive(empty_x + 8 * ((ix - 1) % X_STAGES));
    mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
""", """      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(empty_x + 8 * (ix % X_STAGES));
      mbar_arrive(empty_w16 + 8 * (iw % W16_STAGES));
    }
#pragma unroll
    for (int nb = 0; nb < TV / LOGITS_N; ++nb) fence_operand(acc[nb]);
"""),
    ("""      wgmma_commit();
      if (q > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
""", """      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(empty_w16 + 8 * (iw % W16_STAGES));
    }
""")]
CE_ABLATIONS = {  # name: edits of fused_ce_bwd.cu (hopper.cuh inlined); the
    "kernel": [],  # edited kernels' dx is wrong, only their times are read
    "no dx products": [_NO_DX],
    "no logits products": [_NO_LOGITS],
    "no products (loads, conversion, reductions)": [_NO_DX, _NO_LOGITS],
    "no reductions": [
        ("  if (c.wtid == 0) {\n    const uint32_t src",
         "  if (false) {\n    const uint32_t src")],
    "no async-proxy fence in the converters": [
        ("      fence_proxy_async_smem();\n      mbar_arrive(full_w16",
         "      mbar_arrive(full_w16")],
    "no conversion (converters only signal)": [_NO_CONVERSION],
    "loads and reductions alone": [_NO_DX, _NO_LOGITS, _NO_CONVERSION],
    "converters one unit at a time": [
        ("CONVERT_UNROLL = 2;", "CONVERT_UNROLL = 1;")],
    "converters four units at a time": [
        ("CONVERT_UNROLL = 2;", "CONVERT_UNROLL = 4;")],
    "logits as m64n64": [
        ("constexpr int LOGITS_N = 128;", "constexpr int LOGITS_N = 64;")],
    "logits as m64n256": [
        ("constexpr int LOGITS_N = 128;", "constexpr int LOGITS_N = 256;")],
    "bf16 ring 2 stages (int8 5; x loads two stages ahead)": [
        ("constexpr int W8_STAGES = 3;", "constexpr int W8_STAGES = 5;"),
        ("constexpr int W16_STAGES = 3;", "constexpr int W16_STAGES = 2;")],
    "int8 ring 2 stages (x 5; x loads two stages ahead)": [
        ("constexpr int X_STAGES = 4;", "constexpr int X_STAGES = 5;"),
        ("constexpr int W8_STAGES = 3;", "constexpr int W8_STAGES = 2;")],
    "L2 evict_last on x and the head": [
        ("  tma_load_4d(dst, tm, full + 8 * s, v0, d0, 0, 0);\n"
         "  tma_load_4d(dst + BOX, tm, full + 8 * s, v0 + 128, d0, 0, 0);",
         "  tma_load_4d(dst, tm, full + 8 * s, v0, d0, 0, 0, l2_evict_last());\n"
         "  tma_load_4d(dst + BOX, tm, full + 8 * s, v0 + 128, d0, 0, 0,\n"
         "              l2_evict_last());"),
        ("  tma_load_4d(base + OFF_X + s * X_BYTES, tm, full + 8 * s, d0, row0, "
         "0, 0);",
         "  tma_load_4d(base + OFF_X + s * X_BYTES, tm, full + 8 * s, d0, row0, "
         "0, 0,\n              l2_evict_last());")],
    "shallowest rings (int8 2, bf16 1; each stage released before the "
    "next is awaited)": [
        ("constexpr int W8_STAGES = 3;", "constexpr int W8_STAGES = 2;"),
        ("constexpr int W16_STAGES = 3;", "constexpr int W16_STAGES = 1;"),
        *_SERIAL],
    "order: row blocks fastest over all rows": [
        ("constexpr int ROW_GROUP = 8;", "constexpr int ROW_GROUP = 0;")],
    "order: groups of 4 row blocks": [
        ("constexpr int ROW_GROUP = 8;", "constexpr int ROW_GROUP = 4;")],
    "order: groups of 16 row blocks": [
        ("constexpr int ROW_GROUP = 8;", "constexpr int ROW_GROUP = 16;")]}


def ce_inputs(seed: int = 0):
    """Route B's fused CE inputs on the card (chip_smoke's ``ce_case``),
    with the forward's lse."""
    from chip_smoke import ce_case
    from moka_tpu_torch.ops import fused_ce as fc
    x, w, scale, t, cot = ce_case(*CE_SHAPE, seed)
    return x, w, scale, t, cot, fc.fused_ce_fwd(x, w, scale, t)[1]


def fused_ce_window(iters: int = 10, host_calls: int = 20) -> dict:
    """Device ms a call and host µs a call (as ``flash_window``) of kernels
    8 and 9 through their wrappers at route B's shape."""
    import torch
    from moka_tpu_torch.ops import fused_ce as fc
    x, w, scale, t, cot, lse = ce_inputs()
    out = {"package": fc.__file__}
    for name, call in (
            ("fused_ce_fwd", lambda: fc.fused_ce_fwd(x, w, scale, t)),
            ("fused_ce_bwd",
             lambda: fc.fused_ce_bwd(x, w, scale, t, lse, cot))):
        ms = event_ms(call, iters)
        t0 = time.perf_counter()
        for _ in range(host_calls):
            call()
        host_us = (time.perf_counter() - t0) / host_calls * 1e6
        torch.cuda.synchronize()
        out[name] = {"ms": ms, "host_us": host_us}
        print(f"  {name}: {ms:.4f} ms a call, host {host_us:.1f} us a call",
              flush=True)
    return {"fused_ce": out}


def fused_ce_ablation_window(iters: int = 10) -> dict:
    """Kernel 9 with parts taken out and in other tile orders
    (CE_ABLATIONS), each built by nvcc (all at once) and launched through
    the wrapper in place of the library at route B's shape, twice in
    turn; the unedited copy is also held against the plain version (dx
    within chip_smoke's CE_DX_TOL)."""
    import ctypes
    import torch
    from chip_smoke import CE_DX_TOL
    from moka_tpu_torch.ops import fused_ce as fc
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = build_variants("fused_ce_bwd.cu", CE_ABLATIONS,
                          "moka_fused_ce_bwd", [p] * 7 + [i] * 4 + [p])
    x, w, scale, t, cot, lse = ce_inputs()
    kept = fc._library("fused_ce_bwd")
    out = {name: [] for name in CE_ABLATIONS}
    try:
        fc._libs["fused_ce_bwd"] = libs["kernel"]
        dx = fc.fused_ce_bwd(x, w, scale, t, lse, cot).float()
        ref = fc.fused_ce_bwd_plain(x, w, scale, t, lse, cot).float()
        err = float((dx - ref).norm() / ref.norm())
        print(f"  the unedited copy: dx rel L2 {err:.3e} (tol "
              f"{CE_DX_TOL[1]})", flush=True)
        if err > CE_DX_TOL[1]:
            raise AssertionError("the ablation's unedited kernel 9 is wrong")
        del dx, ref
        for _ in range(2):
            for name, lib in libs.items():
                fc._libs["fused_ce_bwd"] = lib
                out[name].append(event_ms(
                    lambda: fc.fused_ce_bwd(x, w, scale, t, lse, cot),
                    iters))
    finally:
        fc._libs["fused_ce_bwd"] = kept
    for name, ts in out.items():
        print(f"  {name}: {' / '.join(f'{v:.4f}' for v in ts)} ms",
              flush=True)
    return {"fused_ce_ablation": out, "fused_ce_rel_l2": err}


RANK_SHAPE = (4, 1024, 4)  # chip_smoke's rank timing: b, L, head_dim;
                           # question keys 2:L // 8 (126 a sample)


def rank_inputs():
    """chip_smoke's rank timing inputs (``rank_case``, seed 2) with the
    forward's lse and delta: the argument tuples of the three rank
    wrappers."""
    from chip_smoke import rank_case
    from moka_tpu_torch.ops import flash_attention as fa
    b, L, hd = RANK_SHAPE
    q, k, v, mask, dout = rank_case(b, L, hd=hd, seed=2)
    out, lse = fa.flash_rank_fwd(q, k, v, mask, 0, False)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    return (q, k, v, mask, 0, False), \
        (q, k, v, mask, dout, lse, delta, 0, False)


def rank_kernels_window(host_calls: int = 200) -> dict:
    """The three rank kernels through their wrappers at RANK_SHAPE: the
    kernel alone (a CUDA graph of 100 launches, ``graph_ms``), the host's
    µs a call and the wrapper back to back (CUDA events over 50 calls,
    what chip_smoke's table held before)."""
    from moka_tpu_torch.ops import flash_attention as fa
    fwd_args, bwd_args = rank_inputs()
    out = {"package": fa.__file__}
    for name, call in (
            ("flash_rank_fwd", lambda: fa.flash_rank_fwd(*fwd_args)),
            ("flash_rank_bwd_dq", lambda: fa.flash_rank_bwd_dq(*bwd_args)),
            ("flash_rank_bwd_dkv",
             lambda: fa.flash_rank_bwd_dkv(*bwd_args))):
        out[name] = {"device_ms": graph_ms(call),
                     "host_us": host_us(call, host_calls),
                     "back_to_back_ms": event_ms(call, 50)}
        print(f"  {name}: kernel alone {out[name]['device_ms']:.4f} ms, "
              f"host {out[name]['host_us']:.1f} us a call, back to back "
              f"{out[name]['back_to_back_ms']:.4f} ms", flush=True)
    return {"rank_kernels": out}


RANK_ABLATIONS = {  # name: edits of flash_rank.cu; the edited forwards'
    "kernel": [],   # outputs are wrong, only their times are read
    "launch alone (returns at once)": [
        ("  const int* mrow = mask + static_cast<long>(b) * S;\n",
         "  const int* mrow = mask + static_cast<long>(b) * S;\n"
         "  if (L > 0) return;\n")],
    "q not loaded ahead of the mask scan": [
        ("  if (row < L) {\n    load_row<HD>(q + r * HD, qs);",
         "  if (false) {\n    load_row<HD>(q + r * HD, qs);"),
        ("  float acc[HD];\n", "  float acc[HD];\n"
         "  load_row<HD>(q + r * HD, qs);\n")],
    "no key walk (the mask scan, q, the merge, the stores)": [
        ("for (int j0 = lo + lane; j0 <= end; j0 += 32 * U) {",
         "for (int j0 = lo + lane; j0 <= end - S; j0 += 32 * U) {")],
    "every key walked (the span is the whole sample)": [
        ("  // the sum of V over all S keys, for the rows that see no key;",
         "  lo = 0;\n  hi = S - 1;\n"
         "  // the sum of V over all S keys, for the rows that see no key;")],
    "one key a lane at a time": [
        ("constexpr int U = 16 / HD;", "constexpr int U = 1;")],
    "4 warps a CTA": [("constexpr int FWD_WARPS = 8;",
                       "constexpr int FWD_WARPS = 4;")],
    "16 warps a CTA": [("constexpr int FWD_WARPS = 8;",
                        "constexpr int FWD_WARPS = 16;")]}


def swap_timed(install, kept, variants: dict, timers: dict,
               turns: int = 2) -> dict:
    """Each variant library installed by ``install`` in turn (``turns``
    times over) and timed by each of ``timers`` ({name: () -> number});
    ``kept`` installed again after.  {variant: {timer: [a number a
    turn]}}."""
    out = {name: {t: [] for t in timers} for name in variants}
    try:
        for _ in range(turns):
            for name, lib in variants.items():
                install(lib)
                for t, timer in timers.items():
                    out[name][t].append(timer())
    finally:
        install(kept)
    for name, times in out.items():
        print(f"  {name}: " + "; ".join(
            f"{t} {' / '.join(f'{v:.4f}' for v in vs)}"
            for t, vs in times.items()), flush=True)
    return out


def rank_ablation_window() -> dict:
    """The rank forward with parts taken out (RANK_ABLATIONS: edited
    copies of flash_rank.cu, built all at once) at RANK_SHAPE through the
    wrapper, twice in turn: the kernel alone (``graph_ms``) and back to
    back; the unedited copy is first held against the plain version."""
    from chip_smoke import RANK_TOL
    from moka_tpu_torch.ops import flash_attention as fa
    libs = {name: fa.bind("flash_rank", lib) for name, lib in
            finish_variants(start_variants("flash_rank.cu",
                                           RANK_ABLATIONS)).items()}
    fwd_args, _ = rank_inputs()
    kept = fa._library("flash_rank")

    def install(lib):
        fa._libs["flash_rank"] = lib

    try:
        install(libs["kernel"])
        got, _ = fa.flash_rank_fwd(*fwd_args)
    finally:
        install(kept)
    ref, _ = fa.flash_fwd_plain(*fwd_args)
    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"  the unedited copy: out max|err| / max|plain| {err:.2e} (tol "
          f"{RANK_TOL})", flush=True)
    if err > RANK_TOL:
        raise AssertionError("the ablation's unedited rank forward is wrong")

    def call():
        fa.flash_rank_fwd(*fwd_args)

    out = swap_timed(install, kept, libs,
                     {"graph_ms": lambda: graph_ms(call),
                      "back_to_back_ms": lambda: event_ms(call, 50)})
    return {"rank_ablation": out, "rank_rel_err": err}


BD_SHAPES = ((512, 8, 4096), (512, 8, 11008), (1376, 8, 4096))  # (N, b, m)
L2_BYTES = 50e6  # the H100's L2 cache


def bd_inputs(N, b, m, seed: int = 0):
    """Orthogonal fp32 blocks (Cayley of N(0, 0.1^2)) and bf16 x buffers
    that together hold at least 3x the L2 cache (at least 2), for cold
    launches."""
    import math
    import torch
    from moka_tpu_torch.ops import fbd
    g = torch.Generator(device="cuda").manual_seed(seed)
    blocks = fbd.cayley(torch.randn((1, N, b, b), generator=g,
                                    device="cuda") * 0.1)
    one = N * b * m * 2
    xs = [(torch.randn((1, N * b, m), generator=g, device="cuda") * 0.02)
          .bfloat16() for _ in range(max(2, math.ceil(3 * L2_BYTES / one)))]
    return blocks, xs


def bd_timers(blocks, xs) -> dict:
    """Kernel 10's timers on one shape: cold (a CUDA graph rotating over
    ``xs``), warm (a graph on one x), the wrapper back to back on one x
    (the warm loop chip_smoke's table held before), the host's µs a call,
    and a plain copy of x, cold (``x.clone()``: the same bytes moved, what
    the card's memory gives a streaming kernel)."""
    from moka_tpu_torch.ops import fbd
    cold = [lambda x=x: fbd.block_diag_matmul(blocks, x) for x in xs]
    return {"cold_ms": lambda: graph_ms(cold, n=4 * len(xs)),
            "warm_ms": lambda: graph_ms(cold[0], n=20),
            "back_to_back_ms": lambda: event_ms(cold[0], 20),
            "host_us": lambda: host_us(cold[0], 20),
            "copy_cold_ms": lambda: graph_ms([x.clone for x in xs],
                                             n=4 * len(xs))}


def block_diag_window() -> dict:
    """Kernel 10 through its wrapper at the BOFT merge's three shapes
    (``bd_timers``), then one BOFT merge at phase 10's shapes
    (``BoftSpec(8, 2)`` on 224 random bf16 weights at LLaMA-2-7B's widths
    through kernel 10): its wall time untraced, and traced with the
    device time by group."""
    import torch
    from chip_smoke import boft_adapters, boft_merge
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.models.llama import _proj_shapes
    from moka_tpu_torch.ops import fbd
    out = {"package": fbd.__file__}
    for N, b, m in BD_SHAPES:
        blocks, xs = bd_inputs(N, b, m)
        res = {name: t() for name, t in bd_timers(blocks, xs).items()}
        out[f"{N}x{b}x{m}"] = res
        print(f"  block_diag (1, {N}, {b}, {m}) bf16: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()), flush=True)
        del xs
        torch.cuda.empty_cache()
    cfg = LlamaConfig.llama2_7b()
    g = torch.Generator(device="cuda").manual_seed(0)
    base = {"layers": {name: (torch.randn((cfg.n_layers, d_in, d_out),
                                          generator=g, device="cuda")
                              * 0.02).bfloat16()
                       for name, (d_in, d_out) in _proj_shapes(cfg).items()}}
    boft = boft_adapters(cfg)

    def merge():
        boft_merge(cfg, base, boft, use_pallas=True)
        torch.cuda.synchronize()

    with torch.no_grad():
        wall = wall_ms(merge)
        traced, ops, host = trace(merge)
    out["merge"] = summary("BOFT merge (BoftSpec(8, 2), 224 weights, "
                           "kernel 10)", wall, traced, ops, host=host)
    return {"block_diag": out}


_LOADS_ALONE = (
    "    const uint8_t* xs = sm + s * stage_bytes;",
    "    if (t >= 0) {  // ablation: release the stage unread\n"
    "      __syncwarp();\n"
    "      if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + s));\n"
    "      continue;\n    }\n"
    "    const uint8_t* xs = sm + s * stage_bytes;")
BD_ABLATIONS = {  # name: edits of block_diag.cu (hopper.cuh inlined); the
    "kernel": [],  # edited kernels' y is wrong, only their times are read
    "loads alone (each stage released unread, no stores)": [_LOADS_ALONE],
    "stores alone (the producer signals, loads nothing)": [
        ("        mbar_arrive_expect_tx(bars + 8 * s, boxes * sh.tr * "
         "BOX_BYTES);\n        for (int q = 0; q < boxes; ++q)",
         "        mbar_arrive(bars + 8 * s);\n"
         "        for (int q = 0; q < 0; ++q)")],
    "ring of 2 stages": [("constexpr int MAX_STAGES = 4;",
                          "constexpr int MAX_STAGES = 2;")],
    "ring of 6 stages": [("constexpr int MAX_STAGES = 4;",
                          "constexpr int MAX_STAGES = 6;")],
    "one CTA an SM": [("const long ctas = static_cast<long>(sm_count()) * "
                       "per_sm;",
                       "const long ctas = static_cast<long>(sm_count());")],
    "no L2 hint on x (evict_normal)": [("L2::evict_first.b64",
                                         "L2::evict_normal.b64")],
    "streaming stores (st.global.cs)": [
        ("*reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);",
         "__stcs(reinterpret_cast<uint4*>(p), "
         "make_uint4(w[0], w[1], w[2], w[3]));")]}


def block_diag_ablation_window() -> dict:
    """Kernel 10 with parts taken out (BD_ABLATIONS: edited copies of
    block_diag.cu, built all at once) at the merge's first two shapes
    through the wrapper, twice in turn, cold and warm; the unedited copy
    is first held against the plain version (chip_smoke's limit)."""
    import torch
    from chip_smoke import bf16_ulp
    from moka_tpu_torch.ops import fbd
    libs = {name: fbd.bind(lib) for name, lib in
            finish_variants(start_variants("block_diag.cu",
                                           BD_ABLATIONS)).items()}
    kept = fbd._library()

    def install(lib):
        fbd._lib = lib

    out = {}
    for N, b, m in BD_SHAPES[:2]:
        blocks, xs = bd_inputs(N, b, m)
        try:
            install(libs["kernel"])
            y = fbd.block_diag_matmul(blocks, xs[0]).float()
        finally:
            install(kept)
        ref = fbd.block_diag_matmul_plain(blocks, xs[0]).float()
        top = float(ref.abs().max())
        err = float((y - ref).abs().max())
        print(f"  (1, {N}, {b}, {m}): the unedited copy's max|err| "
              f"{err:.3e} (one bf16 ulp of max|plain|: "
              f"{bf16_ulp(top):.3e})", flush=True)
        if err > bf16_ulp(top):
            raise AssertionError("the ablation's unedited kernel 10 is wrong")
        del y, ref
        timers = bd_timers(blocks, xs)
        out[f"{N}x{b}x{m}"] = swap_timed(
            install, kept, libs,
            {t: timers[t] for t in ("cold_ms", "warm_ms")})
        del xs
        torch.cuda.empty_cache()
    return {"block_diag_ablation": out}


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
    kernel_windows = {"flash": flash_window,
                      "flash_ablation": flash_ablation_window,
                      "fused_ce": fused_ce_window,
                      "fused_ce_ablation": fused_ce_ablation_window,
                      "rank_kernels": rank_kernels_window,
                      "rank_ablation": rank_ablation_window,
                      "block_diag": block_diag_window,
                      "block_diag_ablation": block_diag_ablation_window}
    if set(names) - {*WINDOWS, *kernel_windows}:
        print(f"profile_port: windows are {WINDOWS} and "
              f"{tuple(kernel_windows)}", file=sys.stderr)
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
    for name, window in kernel_windows.items():
        if name in names:
            out.update(window())
    if "serving" in names:
        out.update(serving_windows())
    for path in names:
        if path in WINDOWS and path != "serving":
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
