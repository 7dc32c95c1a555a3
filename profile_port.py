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
    python3 profile_port.py fused_ce fused_ce_ablation fused_ce_fwd_ablation
    python3 profile_port.py fused_ce_fwd_clocks
    python3 profile_port.py rank_kernels block_diag [--root DIR]
    python3 profile_port.py rank_ablation rank_bwd_ablation
    python3 profile_port.py block_diag_ablation
    python3 profile_port.py moka_delta [--root DIR]
    python3 profile_port.py moka_prefill [--root DIR]
    python3 profile_port.py moka_ablation
    python3 profile_port.py fused_dropout [--root DIR]
    python3 profile_port.py fused_dropout_ablation dropout_dx_order
    python3 profile_port.py paged_decode [--root DIR]
    python3 profile_port.py paged_decode_ablation
    python3 profile_port.py data_parallel   # one card, or an NCCL world

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
route B's shape (N 4092, d 4096, V 32011, int8 head) the same way, and
each one's device launches alone in a trace (kernel 8's kernel and its
merge; with ``--root``, another checkout's); ``fused_ce_ablation`` and
``fused_ce_fwd_ablation`` time kernels 9 and 8 with parts taken out and
in other tile orders (CE_ABLATIONS, CE_FWD_ABLATIONS: edited copies of
fused_ce_bwd.cu and fused_ce.cu; kernel 8 also in other cluster shapes,
ring depths and converter widths, in FWD_TURNS turns);
``fused_ce_fwd_clocks`` counts kernel 8's cycles by role and step
(CE_FWD_CLOCKS: clock64() counters in an edited copy).  ``rank_kernels`` times the three rank flash
kernels through their wrappers at chip_smoke's rank shape (b 4, L 1024,
head_dim 4, 126 question keys a sample): the kernel alone (``graph_ms``:
a CUDA graph of 100 launches, no host work between them), the host's µs a
call (``host_us``: the least of five batches) and the wrapper back to
back, then each alone at head_dim 16.  ``block_diag`` times kernel 10 at the BOFT merge's three shapes:
cold (a graph rotating over x buffers that together hold 3x the L2
cache), warm, back to back, the host's µs a call and a cold ``x.clone()``
(the same bytes moved by PyTorch's copy), then traces one BOFT merge at
phase 10's shapes (``BoftSpec(8, 2)`` on 224 random bf16 weights at
LLaMA-2-7B's widths).  Both take ``--root``.  ``rank_ablation``,
``rank_bwd_ablation`` and ``block_diag_ablation`` time the rank forward,
the rank backward pair (dq and dk/dv, each alone and back to back) and
kernel 10 with parts taken out (RANK_ABLATIONS, RANK_BWD_ABLATIONS,
BD_ABLATIONS: edited copies of flash_rank.cu and block_diag.cu), twice in
turn.  ``moka_delta`` times the fused MokA
delta (kernel 5) at the serving prefill (b 8, L 896, bf16, AVT) for each
projection shape of LLaMA-2-7B at ranks 4, 8 and 16: the kernel alone in
a CUDA graph, the host's µs a call and the wrapper back to back (with
``--root``, another checkout's; rank 4 alone where that kernel takes no
other).  ``moka_prefill`` times the prefill of the serving batch
(``greedy_generate`` for one new token) for a MokA AVT tree at
MOKA_PREFILL_RANKS, with its defaults and with the unfused delta in the
same process, untraced and traced, by device group, and kernel 5's wide
path (the defaults past rank 64) split into its down product, R1 and up
product from the trace (``--root`` of a parent: its package under the
same window).
``moka_ablation`` times kernel 5 with parts taken out
(MOKA_ABLATIONS: edited copies of moka_delta_fwd.cu), twice in turn.
``fused_dropout`` times kernels 6 and 7 at the fused step's shape (N
4096, bf16 x and A, Philox) for each projection width of LLaMA-2-7B at
AVT ranks 4, 8 and 16 the same way (with ``--root``, another checkout's;
rank 4 alone where its kernels take no other M*r);
``fused_dropout_ablation`` times them with parts taken out
(DROP_ABLATIONS: edited copies of fused_dropout.cu), twice in turn, and
counts a Philox call's SASS instructions and multiplies
(``philox_sass``); ``dropout_dx_order`` counts where kernel 7's dx
differs from cuBLAS's product and from the plain version's in-order
chain.  ``paged_decode`` times the decode kernel through its
wrapper at DECODE_SHAPES (chip_smoke's timed shapes and one sample) on a
bf16 and an int8 cache the same way (with ``--root``, another
checkout's); ``paged_decode_ablation`` times it with parts taken out and
its ring resized (DECODE_ABLATIONS: edited copies of paged_decode.cu),
twice in turn.  ``data_parallel`` times and traces phase 17 (c)'s step
as a rank of the data-parallel mesh computes it (one row, the dropout
key's view of the rank's rows) beside one process on one row and on the
global batch, and with several cards the mesh itself over NCCL.

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
import shutil
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
    ("fused MokA kernels (port)", ("moka_delta_kernel", "wide::",
                                   "question_keys_kernel")),
    ("fused dropout kernels (port)", ("dropout_fwd_", "dropout_bwd_",
                                      "transpose_a_kernel")),
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


_FWD_NO_PRODUCTS = ("        for (int kk = 0; kk < BK / 16; ++kk)\n"
                    "          logits_step(",
                    "        for (int kk = 0; kk < 0; ++kk)\n"
                    "          logits_step(")
_FWD_NO_WIDENING = ("      convert_stage(sm + OFF_W8",
                    "      if (false) convert_stage(sm + OFF_W8")
_FWD_CLUSTER_1X1 = [
    ("constexpr int ROW_PAIR = 2;", "constexpr int ROW_PAIR = 1;")]
_FWD_CLUSTER_2X2 = [
    ("constexpr int VOCAB_PAIR = 1;", "constexpr int VOCAB_PAIR = 2;")]
_FWD_NO_SOFTMAX = ("      release(i - 1);\n\n",
                   "      release(i - 1);\n      continue;\n")
_FWD_LOADS = [_FWD_NO_PRODUCTS, _FWD_NO_WIDENING]
CE_FWD_ABLATIONS = {  # name: edits of fused_ce.cu (hopper.cuh inlined); the
    "kernel": [],      # edited kernels' nll is wrong, only their times are
    "no products": [_FWD_NO_PRODUCTS],  # read
    "no widening (the converters only signal)": [_FWD_NO_WIDENING],
    "no softmax (the tiles' epilogue)": [_FWD_NO_SOFTMAX],
    "loads alone": _FWD_LOADS,
    "loads alone, cluster 1x1": [*_FWD_LOADS, *_FWD_CLUSTER_1X1],
    "loads alone, cluster 2x2": [*_FWD_LOADS, *_FWD_CLUSTER_2X2],
    "no multicast (cluster 1x1)": _FWD_CLUSTER_1X1,
    "x multicast along the vocab pair too (cluster 2x2)": _FWD_CLUSTER_2X2,
    "x multicast alone (cluster 1x2)": [*_FWD_CLUSTER_1X1,
                                        *_FWD_CLUSTER_2X2],
    "every slot release at cluster scope": [
        ("@p mbarrier.arrive.shared::cluster.b64",
         "@p mbarrier.arrive.release.cluster.shared::cluster.b64")],
    "x 5, int8 2 stages": [
        ("constexpr int X_STAGES = 4;", "constexpr int X_STAGES = 5;"),
        ("constexpr int W8_STAGES = 3;", "constexpr int W8_STAGES = 2;")],
    "x 3, int8 2, bf16 4 stages": [
        ("constexpr int X_STAGES = 4;", "constexpr int X_STAGES = 3;"),
        ("constexpr int W8_STAGES = 3;", "constexpr int W8_STAGES = 2;"),
        ("constexpr int W16_STAGES = 3;", "constexpr int W16_STAGES = 4;")],
    "int8 5, bf16 2 stages": [
        ("constexpr int W8_STAGES = 3;", "constexpr int W8_STAGES = 5;"),
        ("constexpr int W16_STAGES = 3;", "constexpr int W16_STAGES = 2;")],
    "two converter warpgroups (consumers at 184 registers)": [
        ("constexpr int NCONVERT = 128;", "constexpr int NCONVERT = 256;")],
    "converters one unit at a time": [
        ("CONVERT_UNROLL = 2;", "CONVERT_UNROLL = 1;")],
    "converters four units at a time": [
        ("CONVERT_UNROLL = 2;", "CONVERT_UNROLL = 4;")],
    "order: row pairs fastest over all rows": [
        ("constexpr int ROW_GROUP = 8;", "constexpr int ROW_GROUP = 1 << 20;")],
    "order: groups of 4 row pairs": [
        ("constexpr int ROW_GROUP = 8;", "constexpr int ROW_GROUP = 4;")]}


CE_FWD_CLOCK_KEYS = (  # kernel 8's clock64() counters (CE_FWD_CLOCKS)
    "load x: waits for a free slot", "load int8: waits for a free slot",
    "converter: waits for the int8 tile", "converter: waits for a bf16 slot",
    "converter: widens and signals", "consumer: waits for x",
    "consumer: waits for the bf16 tile", "consumer: wgmma wait and release",
    "consumer: a tile's stages", "consumer: a tile's softmax", "tiles",
    "CTA: launch to exit", "CTAs")
_CLK = "  { long long c0_ = clock64(); "
CE_FWD_CLOCKS = [  # edits of fused_ce.cu: thread 0 of each role sums the
    # cycles (clock64) of each step in registers, added to g_clk at exit
    ("struct Args {", "__device__ unsigned long long g_clk[16];\n"
     "#define CLK_ADD(k, v) (clk_[k] += (unsigned long long)(v))\n\n"
     "struct Args {"),
    ("                                       int d0, const Tile& t, "
     "uint16_t mask) {",
     "                                       int d0, const Tile& t, "
     "uint16_t mask,\n                                       unsigned long "
     "long* clk_) {"),
    ("  mbar_wait_cluster(empty + 8 * s, ((i / X_STAGES) & 1) ^ 1);",
     _CLK + "mbar_wait_cluster(empty + 8 * s, ((i / X_STAGES) & 1) ^ 1); "
     "CLK_ADD(0, clock64() - c0_); }"),
    ("                                        uint16_t mask) {",
     "                                        uint16_t mask,\n            "
     "                            unsigned long long* clk_) {"),
    ("  mbar_wait_cluster(empty + 8 * s, ((i / W8_STAGES) & 1) ^ 1);",
     _CLK + "mbar_wait_cluster(empty + 8 * s, ((i / W8_STAGES) & 1) ^ 1); "
     "CLK_ADD(1, clock64() - c0_); }"),
    ("        load_x(base, &tm_x, full_x, empty_x, i, stage_d0(i), tl, "
     "x_mask);", "        load_x(base, &tm_x, full_x, empty_x, i, "
     "stage_d0(i), tl, x_mask, clk_);"),
    ("                tl, w_mask);", "                tl, w_mask, clk_);"),
    ("      mbar_wait_cluster(full_w8 + 8 * s8, (i / W8_STAGES) & 1);",
     "      long long c0_ = clock64();\n      mbar_wait_cluster(full_w8 + 8 "
     "* s8, (i / W8_STAGES) & 1);\n      long long c1_ = clock64();"),
    ("      mbar_wait_cluster(empty_w16 + 8 * s16, ((i / W16_STAGES) & 1) ^ "
     "1);\n      convert_stage(", "      mbar_wait_cluster(empty_w16 + 8 * "
     "s16, ((i / W16_STAGES) & 1) ^ 1);\n      long long c2_ = clock64();\n"
     "      convert_stage("),
    ("        mbar_arrive_remote(e8_partner + 8 * s8, lane == 0);\n",
     "        mbar_arrive_remote(e8_partner + 8 * s8, lane == 0);\n      if "
     "(ctid == 0) { CLK_ADD(2, c1_ - c0_); CLK_ADD(3, c2_ - c1_); "
     "CLK_ADD(4, clock64() - c2_); }\n"),
    ("        mbar_wait_cluster(full_x + 8 * sx, (i / X_STAGES) & 1);\n"
     "        mbar_wait_cluster(full_w16 + 8 * sw, (i / W16_STAGES) & 1);",
     "        long long c0_ = clock64();\n        mbar_wait_cluster(full_x + "
     "8 * sx, (i / X_STAGES) & 1);\n        long long c1_ = clock64();\n   "
     "     mbar_wait_cluster(full_w16 + 8 * sw, (i / W16_STAGES) & 1);\n    "
     "    if (tid == 0) { CLK_ADD(5, c1_ - c0_); CLK_ADD(6, clock64() - "
     "c1_); }"),
    ("          wgmma_wait<1>();\n          release(i - 1);",
     "          long long c3_ = clock64();\n          wgmma_wait<1>();\n   "
     "       release(i - 1);\n          if (tid == 0) CLK_ADD(7, clock64() "
     "- c3_);"),
    ("      for (int ks = 0; ks < nk; ++ks, ++i) {",
     "      long long ck_ = clock64();\n      for (int ks = 0; ks < nk; "
     "++ks, ++i) {"),
    ("      release(i - 1);\n\n", "      release(i - 1);\n      long long "
     "ce_ = clock64();\n      if (tid == 0) { CLK_ADD(8, ce_ - ck_); "
     "CLK_ADD(10, 1); }\n\n"),
    ("        tile_softmax<false>(acc, clj, t, v_sub, a.v_real, m, l);\n",
     "        tile_softmax<false>(acc, clj, t, v_sub, a.v_real, m, l);\n    "
     "  if (tid == 0) CLK_ADD(9, clock64() - ce_);\n"),
    ("  const int tid = threadIdx.x;\n  const uint32_t rank = "
     "cluster_rank();", "  const int tid = threadIdx.x;\n  const long long "
     "cta0_ = clock64();\n  unsigned long long clk_[16] = {0};\n  const "
     "uint32_t rank = cluster_rank();"),
    ("  // or arrive on its barriers\n  cluster_sync();\n}",
     "  // or arrive on its barriers\n  cluster_sync();\n  if (tid == 0) { "
     "CLK_ADD(11, clock64() - cta0_); CLK_ADD(12, 1); }\n  for (int k = 0; "
     "k < 16; ++k)\n    if (clk_[k]) atomicAdd(&g_clk[k], clk_[k]);\n}"),
    ("}  // extern \"C\"", "// the counters, then zeroed\nint "
     "moka_clk_read(unsigned long long* out) {\n  cudaError_t e = "
     "cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n  unsigned long long "
     "z[16] = {0};\n  cudaMemcpyToSymbol(g_clk, z, sizeof(g_clk));\n  "
     "return static_cast<int>(e);\n}\n\n}  // extern \"C\"")]


def fused_ce_fwd_clocks_window(launches: int = 5) -> dict:
    """Where kernel 8's cycles go, by role, at route B's shape: a copy of
    fused_ce.cu with CE_FWD_CLOCKS's counters (thread 0 of each role sums
    clock64() cycles of each step) launched ``launches`` times after three
    warm-up launches, held against the plain version; cycles a stage
    (waits, widening), a 256-column tile (its stages, its softmax) and a
    CTA (launch to exit), each an average over its CTAs."""
    import ctypes
    import torch
    from chip_smoke import CE_LSE_TOL
    from moka_tpu_torch.ops import fused_ce as fc
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = build_variants("fused_ce.cu", {"clocks": CE_FWD_CLOCKS},
                         "moka_fused_ce_fwd", [p] * 7 + [i] * 4 + [p])["clocks"]
    lib.moka_clk_read.argtypes = [p]
    lib.moka_clk_read.restype = i
    x, w, scale, t, _, _ = ce_inputs()
    kept = fc._library("fused_ce")
    buf = (ctypes.c_ulonglong * 16)()
    try:
        fc._libs["fused_ce"] = lib
        for _ in range(3):
            fc.fused_ce_fwd(x, w, scale, t)
        torch.cuda.synchronize()
        lib.moka_clk_read(buf)
        for _ in range(launches):
            got = fc.fused_ce_fwd(x, w, scale, t)
        torch.cuda.synchronize()
        lib.moka_clk_read(buf)
        ref = fc.fused_ce_fwd_plain(x, w, scale, t)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    finally:
        fc._libs["fused_ce"] = kept
    if not err <= CE_LSE_TOL:
        raise AssertionError("the counted kernel 8 is wrong")
    v = list(buf)
    tiles, ctas = v[10], v[12]
    stages = tiles * (CE_SHAPE[1] // 64)
    out = {"max_abs_err": err, "ctas": ctas, "tiles": tiles}
    for k, name in enumerate(CE_FWD_CLOCK_KEYS[:10]):
        per, unit = (v[k] / tiles, "tile") if k in (8, 9) else \
            (v[k] / stages, "stage")
        out[name] = {"cycles": v[k], f"per_{unit}": per}
        print(f"  {name}: {per:.1f} cycles a {unit}", flush=True)
    out["cycles_a_cta"] = v[11] / ctas
    print(f"  a CTA, launch to exit: {v[11] / ctas:.1f} cycles ({ctas} CTAs "
          f"in {launches} launches); max|err| {err:.3e}", flush=True)
    return {"fused_ce_fwd_clocks": out}


def ce_inputs(seed: int = 0):
    """Route B's fused CE inputs on the card (chip_smoke's ``ce_case``),
    with the forward's lse."""
    from chip_smoke import ce_case
    from moka_tpu_torch.ops import fused_ce as fc
    x, w, scale, t, cot = ce_case(*CE_SHAPE, seed)
    return x, w, scale, t, cot, fc.fused_ce_fwd(x, w, scale, t)[1]


CE_DEVICE_ENTRIES = ("fused_ce_fwd_kernel", "fused_ce_merge_kernel",
                     "fused_ce_bwd_kernel")  # kernel 8, its merge, kernel 9


def fused_ce_window(iters: int = 10, host_calls: int = 20) -> dict:
    """Device ms a call and host µs a call (as ``flash_window``) of kernels
    8 and 9 through their wrappers at route B's shape, and from a ``trace``
    of ``iters`` calls each device entry of CE_DEVICE_ENTRIES alone (ms a
    launch: kernel 8's kernel and its merge launch, kernel 9's kernel),
    every other device entry of the wrapper (ms a call: its fills and
    casts) and the sum of all of them a call."""
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
        _, ops, _ = trace(lambda: [call() for _ in range(iters)])
        alone = {entry: us / count / 1e3 for key, (count, us) in ops.items()
                 for entry in CE_DEVICE_ENTRIES if entry in key}
        rest = {key[:80]: us / iters / 1e3 for key, (_, us) in ops.items()
                if not any(entry in key for entry in CE_DEVICE_ENTRIES)}
        busy = sum(us for _, us in ops.values()) / iters / 1e3
        out[name] = {"ms": ms, "host_us": host_us, "device_ms": alone,
                     "other_device_ms": rest, "device_sum_ms": busy}
        print(f"  {name}: {ms:.4f} ms a call, host {host_us:.1f} us a call; "
              f"device ms a launch: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in alone.items()) +
              f"; other device ms a call: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in rest.items()) +
              f"; device sum {busy:.4f} ms a call", flush=True)
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


FWD_TURNS = 6  # turns of fused_ce_fwd_ablation, every other one reversed


def fused_ce_fwd_ablation_window(iters: int = 30) -> dict:
    """Kernel 8 with parts taken out, without its clusters' sharing and in
    other shapes and tile orders (CE_FWD_ABLATIONS), each built by nvcc
    (all at once) and launched through the wrapper in place of the library
    at route B's shape, in FWD_TURNS turns, every other turn in reverse
    order, so a drift of the card's clock within a turn favours no
    variant (a line as each is timed, so a hang names its variant); the
    unedited copy is also held against the plain version (nll and lse
    within chip_smoke's CE_LSE_TOL)."""
    import ctypes
    from chip_smoke import CE_LSE_TOL
    from moka_tpu_torch.ops import fused_ce as fc
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = build_variants("fused_ce.cu", CE_FWD_ABLATIONS,
                          "moka_fused_ce_fwd", [p] * 7 + [i] * 4 + [p])
    x, w, scale, t, _, _ = ce_inputs()
    kept = fc._library("fused_ce")
    out = {name: [] for name in CE_FWD_ABLATIONS}
    try:
        fc._libs["fused_ce"] = libs["kernel"]
        got = fc.fused_ce_fwd(x, w, scale, t)
        ref = fc.fused_ce_fwd_plain(x, w, scale, t)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        print(f"  the unedited copy: max|nll, lse err| {err:.3e} (tol "
              f"{CE_LSE_TOL})", flush=True)
        if not err <= CE_LSE_TOL:
            raise AssertionError("the ablation's unedited kernel 8 is wrong")
        del got, ref
        for turn in range(FWD_TURNS):
            for name in list(libs)[::1 if turn % 2 == 0 else -1]:
                fc._libs["fused_ce"] = libs[name]
                out[name].append(event_ms(
                    lambda: fc.fused_ce_fwd(x, w, scale, t), iters))
                print(f"    turn {turn} {name}: {out[name][-1]:.4f} ms",
                      flush=True)
    finally:
        fc._libs["fused_ce"] = kept
    for name, ts in out.items():
        print(f"  {name}: {' / '.join(f'{v:.4f}' for v in ts)} ms",
              flush=True)
    return {"fused_ce_fwd_ablation": out, "fused_ce_fwd_err": err}


RANK_SHAPE = (4, 1024, 4)  # chip_smoke's rank timing: b, L, head_dim;
                           # question keys 2:L // 8 (126 a sample)


def rank_inputs(hd: int = RANK_SHAPE[2]):
    """chip_smoke's rank timing inputs (``rank_case``, seed 2) at head_dim
    ``hd`` with the forward's lse and delta: the argument tuples of the
    three rank wrappers."""
    from chip_smoke import rank_case
    from moka_tpu_torch.ops import flash_attention as fa
    b, L, _ = RANK_SHAPE
    q, k, v, mask, dout = rank_case(b, L, hd=hd, seed=2)
    out, lse = fa.flash_rank_fwd(q, k, v, mask, 0, False)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    return (q, k, v, mask, 0, False), \
        (q, k, v, mask, dout, lse, delta, 0, False)


def rank_calls(hd: int = RANK_SHAPE[2]) -> dict:
    """{wrapper name: a call of it on ``rank_inputs(hd)``}."""
    from moka_tpu_torch.ops import flash_attention as fa
    fwd_args, bwd_args = rank_inputs(hd)
    return {"flash_rank_fwd": lambda: fa.flash_rank_fwd(*fwd_args),
            "flash_rank_bwd_dq": lambda: fa.flash_rank_bwd_dq(*bwd_args),
            "flash_rank_bwd_dkv": lambda: fa.flash_rank_bwd_dkv(*bwd_args)}


def rank_kernels_window(host_calls: int = 200) -> dict:
    """The three rank kernels through their wrappers at RANK_SHAPE: the
    kernel alone (a CUDA graph of 100 launches, ``graph_ms``), the host's
    µs a call and the wrapper back to back (CUDA events over 50 calls,
    what chip_smoke's table held before); then each alone at head_dim
    16."""
    from moka_tpu_torch.ops import flash_attention as fa
    out = {"package": fa.__file__}
    for name, call in rank_calls().items():
        out[name] = {"device_ms": graph_ms(call),
                     "host_us": host_us(call, host_calls),
                     "back_to_back_ms": event_ms(call, 50)}
        print(f"  {name}: kernel alone {out[name]['device_ms']:.4f} ms, "
              f"host {out[name]['host_us']:.1f} us a call, back to back "
              f"{out[name]['back_to_back_ms']:.4f} ms", flush=True)
    for name, call in rank_calls(16).items():
        out[name]["device_ms_hd16"] = graph_ms(call)
        print(f"  {name} at head_dim 16: kernel alone "
              f"{out[name]['device_ms_hd16']:.4f} ms", flush=True)
    return {"rank_kernels": out}


RANK_ABLATIONS = {  # name: edits of flash_rank.cu; the edited forwards'
    "kernel": [],   # outputs are wrong, only their times are read
    "launch alone (returns at once)": [
        ("  const int* mrow = mask + static_cast<long>(b) * S;\n",
         "  const int* mrow = mask + static_cast<long>(b) * S;\n"
         "  if (L > 0) return;\n")],
    "q not loaded ahead of the mask scan": [
        ("  if (row < L) {\n    load_row<W>(q + r * HD + g * W, qs);",
         "  if (false) {\n    load_row<W>(q + r * HD + g * W, qs);"),
        ("  float acc[W];\n", "  float acc[W];\n"
         "  load_row<W>(q + r * HD + g * W, qs);\n")],
    "no key walk (the mask scan, q, the merge, the stores)": [
        ("for (int j0 = lo + slot; j0 <= end; j0 += SLOTS * U) {",
         "for (int j0 = lo + slot; j0 <= end - S; j0 += SLOTS * U) {")],
    "every key walked (the span is the whole sample)": [
        ("  // the sum of V over all S keys, for the rows that see no key;",
         "  lo = 0;\n  hi = S - 1;\n"
         "  // the sum of V over all S keys, for the rows that see no key;")],
    "one key a lane at a time": [
        ("constexpr int U = 16 / W;", "constexpr int U = 1;")],
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
        for turn in range(turns):
            for name, lib in variants.items():
                print(f"  timing {name} (turn {turn + 1})", flush=True)
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


RANK_BWD_ABLATIONS = {  # name: edits of flash_rank.cu's dq (R2) and dk/dv
    "kernel": [],        # (R3); the edited kernels' outputs are wrong, only
    "launch alone (returns at once)": [  # their times are read
        ("  const int* keys_on = mask + static_cast<long>(b) * S;\n",
         "  const int* keys_on = mask + static_cast<long>(b) * S;\n"
         "  if (L > 0) return;\n"),
        ("  const long k_base = static_cast<long>(b) * S;\n",
         "  const long k_base = static_cast<long>(b) * S;\n"
         "  if (L > 0) return;\n")],
    "no key walk (dq), no query walk (dk/dv)": [
        ("for (int j0 = first + slot; j0 <= stop; j0 += SLOTS * KIF) {",
         "for (int j0 = first + slot; j0 <= stop - S; j0 += SLOTS * KIF) {"),
        ("for (; c < n; c += PHASES * QIF) {",
         "for (; c < n - CHUNK; c += PHASES * QIF) {")],
    "the whole sample walked (every key of a row, every key's queries)": [
        ("  const int first = span.x, last = span.y;",
         "  const int first = 0, last = S - 1;"),
        ("  const int lo = span.x, hi = span.y;",
         "  const int lo = 0, hi = S - 1;"),
        ("      if (j <= hi && __ldg(m + j) > 0) {", "      if (j <= hi) {")],
    "one key (dq), one query (dk/dv) in flight a lane": [
        ("  constexpr int KIF = 16 / W;", "  constexpr int KIF = 1;"),
        ("  constexpr int QIF = 16 / W;", "  constexpr int QIF = 1;")],
    "dk/dv: chunks of 2048 / r queries (21 KB at r 4)": [
        ("  constexpr int CHUNK = (HD >= 32 ? 2048 : 4096) / HD;",
         "  constexpr int CHUNK = 2048 / HD;")],
    "dk/dv: 2 keys a block": [
        ("constexpr int BWD_KEYS = 4;", "constexpr int BWD_KEYS = 2;")],
    "dk/dv: 8 keys a block": [
        ("constexpr int BWD_KEYS = 4;", "constexpr int BWD_KEYS = 8;")],
    "dk/dv: 16 warps a CTA": [
        ("constexpr int BWD_NT = 256;", "constexpr int BWD_NT = 512;")],
    "dk/dv: work CTAs for a span of S / 4 keys": [
        ("constexpr int SPAN_SHARE = 8;", "constexpr int SPAN_SHARE = 4;")],
    "dk/dv: work CTAs for a span of S / 16 keys": [
        ("constexpr int SPAN_SHARE = 8;", "constexpr int SPAN_SHARE = 16;")]}


def rank_bwd_ablation_window() -> dict:
    """The rank backward, dq (R2) and dk/dv (R3), with parts taken out
    (RANK_BWD_ABLATIONS: edited copies of flash_rank.cu, built all at
    once) at RANK_SHAPE through the wrappers, twice in turn: each kernel
    alone (``graph_ms``) and back to back; the unedited copy is first held
    against the plain versions."""
    from chip_smoke import RANK_BWD_TOL
    from moka_tpu_torch.ops import flash_attention as fa
    libs = {name: fa.bind("flash_rank", lib) for name, lib in
            finish_variants(start_variants("flash_rank.cu",
                                           RANK_BWD_ABLATIONS)).items()}
    _, bwd_args = rank_inputs()
    kept = fa._library("flash_rank")

    def install(lib):
        fa._libs["flash_rank"] = lib

    try:
        install(libs["kernel"])
        got = (fa.flash_rank_bwd_dq(*bwd_args),
               *fa.flash_rank_bwd_dkv(*bwd_args))
    finally:
        install(kept)
    ref = fa.flash_bwd_plain(*bwd_args)
    err = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, ref))
    print(f"  the unedited copy: dq, dk, dv max|err| / max|plain| {err:.2e} "
          f"(tol {RANK_BWD_TOL})", flush=True)
    if err > RANK_BWD_TOL:
        raise AssertionError("the ablation's unedited rank backward is wrong")
    calls = rank_calls()
    timers = {}
    for kernel in ("dq", "dkv"):
        call = calls[f"flash_rank_bwd_{kernel}"]
        timers[f"{kernel}_graph_ms"] = lambda call=call: graph_ms(call)
        timers[f"{kernel}_back_to_back_ms"] = \
            lambda call=call: event_ms(call, 50)
    out = swap_timed(install, kept, libs, timers)
    return {"rank_bwd_ablation": out, "rank_bwd_rel_err": err}


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


MOKA_SHAPE = (8, 896)  # chip_smoke's serving prefill: b, L
MOKA_PROJS = {"q, k, v, o": ((4096, 4096), 4), "gate, up": ((4096, 11008), 2),
              "down": ((11008, 4096), 1)}  # LLaMA-2-7B: (d_in, d_out), count
MOKA_RANKS = (4, 8, 16, 32, 6)  # 6: a padded rank (the rank-8 instance)


def moka_case(d_in, d_out, rank, seed: int = 0):
    """chip_smoke's serving-prefill inputs for one projection: bf16 x ~
    N(0, 1), Kaiming-uniform fp32 A, B ~ N(0, 0.02^2), MokA AVT at
    ``rank``, ``avt_masks``'s layout (text / video / audio = 1/2, 1/4, 1/4
    of the prompt, question span [2, 130)); the arguments of
    ``moka_delta_fused``.  Built here, not imported from chip_smoke, so
    that ``--root`` can time another checkout's wrapper."""
    import math
    import torch
    from moka_tpu_torch.ops.moka import MokaSpec
    b, L = MOKA_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    spec = MokaSpec.avt(rank=rank, dropout_rate=0.0)
    x = torch.randn((b, L, d_in), generator=g, device="cuda").bfloat16()
    bound = 1.0 / math.sqrt(d_in)
    a = torch.rand((3, d_in, rank), generator=g, device="cuda") * 2 * bound \
        - bound
    bm = torch.randn((rank, d_out), generator=g, device="cuda") * 0.02
    mod = torch.zeros((3, b, L), device="cuda")
    mod[0, :, :L // 2], mod[1, :, L // 2:3 * L // 4] = 1, 1
    mod[2, :, 3 * L // 4:] = 1
    qm = torch.zeros((b, L), device="cuda")
    qm[:, 2:130] = 1
    return x, a, bm, mod, qm, spec


def moka_delta_window(host_calls: int = 50) -> dict:
    """Kernel 5 through its wrapper at the serving prefill (MOKA_SHAPE,
    bf16, AVT) for each projection shape of LLaMA-2-7B at MOKA_RANKS (4,
    8 and 16, or rank 4 alone, for a checkout whose kernel takes only
    those, as ``--root`` of a parent): the kernel alone (``graph_ms``, a CUDA
    graph of 20 launches; x, 59-158 MB, overflows the 50 MB L2, so it is
    read from HBM), the host's µs a call and the wrapper back to back; a
    layer sums the seven projections."""
    from moka_tpu_torch.ops import moka_pallas as mp
    ranks = MOKA_RANKS if hasattr(mp, "kernel_rank") else (4, 8, 16) \
        if hasattr(mp, "fused_moka_supported") else (4,)
    out = {"package": mp.__file__}
    for rank in ranks:
        layer = {"graph_ms": 0.0, "back_to_back_ms": 0.0}
        for name, ((d_in, d_out), count) in MOKA_PROJS.items():
            args = moka_case(d_in, d_out, rank)

            def call():
                mp.moka_delta_fused(*args)

            res = {"graph_ms": graph_ms(call, n=20),
                   "host_us": host_us(call, host_calls),
                   "back_to_back_ms": event_ms(call, 20)}
            out[f"r{rank} {d_in}->{d_out}"] = res
            for k in layer:
                layer[k] += count * res[k]
            print(f"  r{rank} {name} {d_in}->{d_out}: kernel alone "
                  f"{res['graph_ms']:.4f} ms, host {res['host_us']:.1f} us a "
                  f"call, back to back {res['back_to_back_ms']:.4f} ms",
                  flush=True)
            del args
        out[f"r{rank} layer"] = layer
        print(f"  r{rank} a layer: kernel alone {layer['graph_ms']:.4f} ms, "
              f"back to back {layer['back_to_back_ms']:.4f} ms", flush=True)
    return {"moka_delta": out}


MOKA_PREFILL_RANKS = (128, 512)
WIDE_PARTS = ("down", "R1", "up")  # kernel 5's wide path, in launch order


def wide_part(key: str) -> str | None:
    """The part of kernel 5's wide path a device entry belongs to (its
    down product with the split of A, R1 past head_dim 64, its up product
    with the pass that forms buf), by kernel name; None for any other."""
    if "flash_rank_fwd_wide" in key:
        return "R1"
    if "wide::" not in key:
        return None
    return "up" if "true>" in key or "prep_kernel" in key else "down"


def moka_prefill_window() -> dict:
    """The serving prefill (``greedy_generate`` for one new token,
    chip_smoke's phase-4 batch: LLaMA-2-7B, b 8, L 896, bf16 base, random
    weights from a seed) for a MokA AVT tree at each of MOKA_PREFILL_RANKS
    (B seeded non-zero), with the defaults (``fused_moka_route``: kernel 5
    where it takes the spec) and with the unfused delta
    (``use_fused_moka=False``) in the same process: the wall untraced and
    traced, the device busy time and its groups, and kernel 5's wide path
    split into its down product, R1 and up product (device ms and
    launches, ``wide_part``)."""
    import torch
    from chip_smoke import build_model, main_path_inputs
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.eval.decode import fused_moka_route, greedy_generate
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.moka import MokaSpec
    cfg = LlamaConfig.llama2_7b()
    base, _ = build_model(cfg, MokaSpec.avt(rank=4, dropout_rate=0.0))
    inputs = main_path_inputs(cfg, base, BATCH, PROMPT)
    out = {"package": llama.__file__}
    for rank in MOKA_PREFILL_RANKS:
        spec = MokaSpec.avt(rank=rank, dropout_rate=0.0)
        g = torch.Generator(device="cuda").manual_seed(rank)
        adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
        for p in adapters["layers"].values():
            p["b"].normal_(0.0, 0.02, generator=g)
        fused = fused_moka_route(torch.device("cuda"), None, cfg, spec)
        for route, flag in (("defaults", None), ("unfused", False)):
            def gen():
                greedy_generate(base, adapters, cfg=cfg, spec=spec,
                                max_new_tokens=1, eos_id=-1,
                                use_fused_moka=flag, **inputs)

            with torch.inference_mode():
                wall = wall_ms(gen)
                traced, ops, _ = trace(gen)
            kernel_5 = bool(fused) and flag is None
            rec = summary(
                f"prefill, MokA AVT r{rank} (b {BATCH}, L {PROMPT}; "
                f"{route}: delta {'kernel 5' if kernel_5 else 'unfused'})",
                wall, traced, ops)
            rec["kernel_5"] = kernel_5
            parts = {part: {"ms": 0.0, "launches": 0} for part in WIDE_PARTS}
            for key, (count, us) in ops.items():
                part = wide_part(key)
                if part is not None:
                    parts[part]["ms"] += us / 1e3
                    parts[part]["launches"] += count
            if kernel_5:
                rec["wide_path"] = parts
                print("  kernel 5's wide path: " + "; ".join(
                    f"{part} {v['ms']:.3f} ms in {v['launches']} launches"
                    for part, v in parts.items()), flush=True)
            out[f"r{rank}" if flag is None else f"r{rank}_unfused"] = rec
        del adapters
        gc.collect()
        torch.cuda.empty_cache()
    return {"moka_prefill": out}


_MOKA_NO_DOWN = ("        for (int kk = 0; kk < 4; ++kk)\n"
                 "          wgmma_m64nN_ss<C::NP>(",
                 "        for (int kk = 0; kk < 0; ++kk)\n"
                 "          wgmma_m64nN_ss<C::NP>(")
MOKA_ABLATIONS = {  # name: edits of moka_delta_fwd.cu (hopper.cuh inlined);
    "kernel": [],   # the edited kernels' delta is wrong, only times count
    "loads alone (x stages released unread; no B, attention or stores)": [
        _MOKA_NO_DOWN,
        ("        for (int ch = 0; ch < sh.chunks; ++ch, ++jt) {\n"
         "          const int s = jt % C::B_STAGES;",
         "        for (int ch = 0; ch < 0; ++ch, ++jt) {\n"
         "          const int s = jt % C::B_STAGES;"),
        ("    named_bar_sync(1, CONSUMERS);  // buf and the queries written\n",
         "    named_bar_sync(1, CONSUMERS);  // buf and the queries written\n"
         "    if (sh.kb > 0) continue;  // ablation: the loads alone\n")],
    "no down product (x and A still loaded)": [_MOKA_NO_DOWN],
    "no attention (keys staged, not walked)": [
        ("          for (int kq = half; kq < cn; kq += 2) {",
         "          for (int kq = half; kq < 0; kq += 2) {")],
    "no up product (the stores alone)": [
        ("      for (int kk = 0; kk < C::KPAD / 16; ++kk)\n#pragma unroll\n"
         "        for (int n = 0; n < C::BOXES; ++n)",
         "      for (int kk = 0; kk < 0; ++kk)\n#pragma unroll\n"
         "        for (int n = 0; n < C::BOXES; ++n)")],
    "no stores (chunks computed and staged)": [
        ("        tma_store_4d(&tm_out, src, C::CHUNK * ch, row, bi, 0, first);\n"
         "        if (C::BOXES == 2 && C::CHUNK * ch + 64 < a.d_out)\n"
         "          tma_store_4d(&tm_out, src + WBOX, C::CHUNK * ch + 64, row, "
         "bi, 0,\n                       first);\n", "")],
    "the key pass alone (no main kernel)": [
        ("  moka_delta_kernel<R, M><<<grid, NT, smem, st>>>(tm_x, tm_at, "
         "tm_b, tm_out,\n                                                   "
         "a, sh);\n", "")],
    "ring of 4 stages": [("constexpr int MAX_STAGES = 8;",
                          "constexpr int MAX_STAGES = 4;")]}
MOKA_ABLATION_CASES = ((4, 4096, 4096), (4, 4096, 11008), (16, 4096, 11008),
                       (16, 11008, 4096))


def moka_ablation_window() -> dict:
    """Kernel 5 with parts taken out (MOKA_ABLATIONS: edited copies of
    moka_delta_fwd.cu, built all at once) through the wrapper at
    MOKA_ABLATION_CASES (rank, d_in, d_out; MOKA_SHAPE, bf16, AVT), the
    kernel alone (``graph_ms``) twice in turn; the unedited copy is first
    held against the plain version (chip_smoke's MOKA_TOL)."""
    from chip_smoke import MOKA_TOL
    from moka_tpu_torch.ops import moka_pallas as mp
    libs = {name: mp.bind(lib) for name, lib in
            finish_variants(start_variants("moka_delta_fwd.cu",
                                           MOKA_ABLATIONS)).items()}
    kept = mp._library()

    def install(lib):
        mp._lib = lib

    cases = {f"r{r} {i}->{o}": moka_case(i, o, r)
             for r, i, o in MOKA_ABLATION_CASES}
    errs = {}
    for name, args in cases.items():
        try:
            install(libs["kernel"])
            got = mp.moka_delta_fused(*args).float()
        finally:
            install(kept)
        ref = mp.moka_delta_fused_plain(*args).float()
        errs[name] = float((got - ref).abs().max() / ref.abs().max())
        print(f"  the unedited copy, {name}: max|err| / max|plain| "
              f"{errs[name]:.2e} (tol {MOKA_TOL['bfloat16']})", flush=True)
        if errs[name] > MOKA_TOL["bfloat16"]:
            raise AssertionError("the ablation's unedited kernel 5 is wrong")
        del got, ref
    timers = {name: (lambda args=args: graph_ms(
        lambda: mp.moka_delta_fused(*args), n=20)) for name, args in
        cases.items()}
    out = swap_timed(install, kept, libs, timers)
    return {"moka_ablation": out, "moka_rel_err": errs}


DROP_N = 4096  # chip_smoke's training rows (b 4 x L 1024)
DROP_PROJS = {"q, k, v, o, gate, up": (4096, 6), "down": (11008, 1)}  # d,
                                                     # count (LLaMA-2-7B)
DROP_MRS = {4: 12, 8: 24, 16: 48, 32: 96, 6: 18}  # AVT rank: M * r (18
                                                 # and 96: past the old set)


def dropout_case(d, mr, seed: int = 0):
    """chip_smoke's fused-dropout timing inputs for one projection: bf16 x
    (N, d) ~ N(0, 1), Kaiming-uniform bf16 A (d, M*r), an fp32 cotangent
    (N, M*r) and a key (Philox).  Built here, not imported from
    chip_smoke, so that ``--root`` can time another checkout's wrapper."""
    import math
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((DROP_N, d), generator=g, device="cuda").bfloat16()
    a = ((torch.rand((d, mr), generator=g, device="cuda") * 2 - 1) /
         math.sqrt(d)).bfloat16()
    gout = torch.randn((DROP_N, mr), generator=g, device="cuda")
    return x, a, gout, DropoutKey(1000 + seed)


def fused_dropout_window(host_calls: int = 50) -> dict:
    """Kernels 6 and 7 through their wrappers at the fused step's shape (N
    4096, x and A bf16, Philox, rate 0.05) for each projection width of
    LLaMA-2-7B at the AVT ranks of DROP_MRS (4, 8 and 16, or rank 4
    alone, for a checkout whose kernels take only those, as ``--root`` of
    a parent): the kernel
    alone (``graph_ms``, a CUDA graph of 20 launches; x is 33-90 MB), the
    host's µs a call and the wrapper back to back; a layer sums the seven
    projections."""
    from moka_tpu_torch.ops import fused_dropout as fd
    wide = hasattr(fd, "fused_dropout_supported") and \
        fd.fused_dropout_supported(96, 4096)
    ranks = DROP_MRS if wide else \
        {r: m for r, m in DROP_MRS.items() if r in (4, 8, 16)} \
        if hasattr(fd, "fused_dropout_supported") else {4: 12}
    out = {"package": fd.__file__}
    for rank, mr in ranks.items():
        layer = {f"{k}_{t}": 0.0 for k in ("fwd", "bwd")
                 for t in ("graph_ms", "back_to_back_ms")}
        for name, (d, count) in DROP_PROJS.items():
            x, a, gout, key = dropout_case(d, mr)
            calls = {"fwd": lambda: fd.dropout_a_fwd(x, a, key, 0.05),
                     "bwd": lambda: fd.dropout_a_bwd(x, a, gout, key, 0.05)}
            for which, call in calls.items():
                res = {"graph_ms": graph_ms(call, n=20),
                       "host_us": host_us(call, host_calls),
                       "back_to_back_ms": event_ms(call, 20)}
                out[f"r{rank} {which} d {d}"] = res
                for k in ("graph_ms", "back_to_back_ms"):
                    layer[f"{which}_{k}"] += count * res[k]
                print(f"  r{rank} (M*r {mr}) {which} {name} d {d}: kernel "
                      f"alone {res['graph_ms']:.4f} ms, host "
                      f"{res['host_us']:.1f} us a call, back to back "
                      f"{res['back_to_back_ms']:.4f} ms", flush=True)
            del x, a, gout
        out[f"r{rank} layer"] = layer
        print(f"  r{rank} a layer: forward alone {layer['fwd_graph_ms']:.4f} "
              f"ms (back to back {layer['fwd_back_to_back_ms']:.4f}), "
              f"backward alone {layer['bwd_graph_ms']:.4f} ms (back to back "
              f"{layer['bwd_back_to_back_ms']:.4f})", flush=True)
    return {"fused_dropout": out}


DX_ORDER_MRS = (18, 96, 192, 256)  # M*r where kernel 7's dx order is shown
DX_ORDER_SHAPES = ((333, 200), (4096, 4096))  # (N, d): ragged and full


def dropout_dx_order_window() -> dict:
    """Why the plain kernel-7 backward forms g A^T as its own chain: at
    each (N, d) of DX_ORDER_SHAPES and M*r of DX_ORDER_MRS (fp32 x and A,
    forced words), the count of the kernel's dx elements that differ from
    (a) cuBLAS's ``g @ A^T`` times the mask, (b) the same rows inside a
    4096-row product (whose sum over M*r cuBLAS does not split) and (c)
    ``dropout_a_bwd_plain`` (the in-order ``addcmul_`` chain)."""
    import torch
    from moka_tpu_torch.ops import fused_dropout as fd
    out = {}
    for n, d in DX_ORDER_SHAPES:
        for mr in DX_ORDER_MRS:
            g = torch.Generator(device="cuda").manual_seed(mr)
            x = torch.randn((n, d), generator=g, device="cuda")
            a = (torch.rand((d, mr), generator=g, device="cuda") * 2 - 1) \
                / d ** 0.5
            gout = torch.randn((n, mr), generator=g, device="cuda")
            bits = torch.randint(0, 1 << 32, (n, d), generator=g,
                                 device="cuda", dtype=torch.int64)
            m = torch.where(bits < fd.threshold(0.05), 1.0 / 0.95, 0.0)
            dx, _ = fd.dropout_a_bwd(x, a, gout, None, 0.05, bits)
            tall = torch.zeros((max(n, 4096), mr), device="cuda")
            tall[:n] = gout
            rows = {"cublas": gout @ a.t(), "cublas_tall": (tall @ a.t())[:n],
                    "plain": fd.dropout_a_bwd_plain(x, a, gout, None, 0.05,
                                                    bits)[0]}
            res = {k: int((dx != (v if k == "plain" else v * m)).sum())
                   for k, v in rows.items()}
            out[f"({n}, {d}) M*r {mr}"] = res
            print(f"  ({n}, {d}) M*r {mr}: dx elements that differ of "
                  f"{n * d}: {res}", flush=True)
    return {"dropout_dx_order": out}


DECODE_SHAPES = {  # name: (B, H, K, S, length, left pads), chip_smoke's
    "7B serving": (8, 32, 32, 1024, 928, 7),           # DECODE_TIMED
    "infer's cache": (8, 32, 32, 1280, 1025, 7),
    "llama2_70b heads, GQA 64:8": (4, 64, 8, 1024, 700, 9),
    "one sample": (1, 32, 32, 4096, 3000, 5)}


def decode_case(B, H, K, S, length, pads, quantized, seed: int = 0):
    """The decode kernel's arguments at a DECODE_SHAPES shape: q and a
    2-layer cache from ``seed`` (bf16, or int8 codes with fp32 scales),
    row i's first ``pads * i // B`` keys masked, the last row without
    keys.  Built here, not imported from chip_smoke, so that ``--root``
    can time another checkout's wrapper."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, H, 128), generator=g, device="cuda").bfloat16()
    shape = (2, B, S, K, 128)
    sides = []
    for _ in range(2):
        x = torch.randn(shape, generator=g, device="cuda")
        if quantized:
            s = x.abs().amax(dim=-1, keepdim=True) / 127.0
            sides.append({"q": torch.round(x / s).to(torch.int8), "s": s})
        else:
            sides.append(x.bfloat16())
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    for i in range(B):
        mask[i, :pads * i // B] = 0
    if B > 1:
        mask[B - 1] = 0
    return q, sides[0], sides[1], mask, 1, length


def decode_window(host_calls: int = 200) -> dict:
    """The decode kernel through its wrapper at DECODE_SHAPES on a bf16 and
    an int8 cache: the kernel alone (``graph_ms``, a CUDA graph of 100
    launches), the host's µs a call (``host_us``) and the wrapper back to
    back (with ``--root``, another checkout's)."""
    from moka_tpu_torch.ops import paged_decode as pd
    out = {"package": pd.__file__}
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        for name, (B, H, K, S, length, pads) in DECODE_SHAPES.items():
            args = decode_case(B, H, K, S, length, pads, quantized)

            def call():
                pd.paged_decode_attention(*args)

            res = {"graph_ms": graph_ms(call),
                   "host_us": host_us(call, host_calls),
                   "back_to_back_ms": event_ms(call, 50)}
            out[f"{name}, {kind}"] = res
            print(f"  decode {name}, {kind} cache: kernel alone "
                  f"{res['graph_ms']:.4f} ms, host {res['host_us']:.1f} us a "
                  f"call, back to back {res['back_to_back_ms']:.4f} ms",
                  flush=True)
            del args
    return {"paged_decode": out}


DECODE_ABLATIONS = {  # name: edits of paged_decode.cu (hopper.cuh inlined);
    "kernel": [],     # the edited kernels' outputs are wrong, only times
    "consumers idle (the loads alone)": [
        ("    const uint32_t kb = ring + s * C::STAGE, vb = kb + C::SIDE;\n",
         "    const uint32_t kb = ring + s * C::STAGE, vb = kb + C::SIDE;\n"
         "    if (true) {\n      __syncwarp();\n"
         "      if (lane == 0) mbar_arrive(empty0 + 8 * s);\n"
         "      continue;\n    }\n")],
    "no P v": [("#pragma unroll\n        for (int i = 0; i < 4; ++i) "
                "mma(o[4 * G4 + i], pa0, pa2, b0[i], b1[i]);",
                "#pragma unroll\n        for (int i = 0; i < 0; ++i) "
                "mma(o[4 * G4 + i], pa0, pa2, b0[i], b1[i]);"),
               ("        mma(o[2 * jp], pa0, pa2, vr[jp][0], vr[jp][1]);\n"
                "        mma(o[2 * jp + 1], pa0, pa2, vr[jp][2], vr[jp][3]);\n",
                "")],
    "bf16 ring of 2 stages": [
        ("static constexpr int STAGES = INT8 ? 2 : 3;",
         "static constexpr int STAGES = 2;")],
    "int8 ring of 4 stages": [
        ("static constexpr int STAGES = INT8 ? 2 : 3;",
         "static constexpr int STAGES = INT8 ? 4 : 3;")],
    "rings of 4 stages, one CTA an SM": [
        ("static constexpr int STAGES = INT8 ? 2 : 3;",
         "static constexpr int STAGES = 4;"),
        ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")]}


def decode_ablation_window(turns: int = 2) -> dict:
    """The decode kernel with parts taken out or its ring resized
    (DECODE_ABLATIONS: edited copies of paged_decode.cu) at the 7B serving
    shape and one sample, each cache, alone in a CUDA graph, ``turns``
    times in turn."""
    from moka_tpu_torch.ops import paged_decode as pd
    libs = finish_variants(start_variants("paged_decode.cu",
                                          DECODE_ABLATIONS))
    kept = pd._library()
    out = {}
    try:
        for quantized in (False, True):
            kind = "int8" if quantized else "bf16"
            for name in ("7B serving", "one sample"):
                B, H, K, S, length, pads = DECODE_SHAPES[name]
                args = decode_case(B, H, K, S, length, pads, quantized)
                for turn in range(turns):
                    for what, lib in libs.items():
                        pd._lib = pd.bind(lib)

                        def call():
                            pd.paged_decode_attention(*args)

                        ms = graph_ms(call)
                        out.setdefault(f"{name}, {kind}: {what}", []).append(
                            ms)
                        print(f"  decode {name}, {kind} cache, {what}: "
                              f"alone {ms:.4f} ms", flush=True)
                del args
    finally:
        pd._lib = kept
    return {"paged_decode_ablation": out}


_DROP_NO_PHILOX = (
    "    const uint32_t g = (static_cast<uint32_t>(c) >> 2) + rk.col;\n"
    "    const uint32_t row = counter_row(rk, n);\n"
    "    philox(row, g, rk, w);\n"
    "    philox(row, g + 1u, rk, w + 4);\n",
    "    for (int e = 0; e < 8; ++e) w[e] = 0u;  // ablation: every word "
    "kept\n")
DROP_ABLATIONS = {  # name: edits of fused_dropout.cu (hopper.cuh inlined);
    "kernel": [],   # the edited kernels' results are wrong, only times count
    "no generator (a constant mask: every word kept)": [_DROP_NO_PHILOX],
    "forward: loads alone (stages released unread)": [
        ("    mbar_wait(full + 8 * s, (it / sh.stages) & 1);\n",
         "    mbar_wait(full + 8 * s, (it / sh.stages) & 1);\n"
         "    if (lane == 0) mbar_arrive(empty + 8 * s);  // ablation\n"
         "    continue;\n")],
    "forward: no products": [
        ("      for (int kk = 0; kk < 4; ++kk)\n"
         "        wgmma_m64nN_ss<FWD_ROWS>(",
         "      for (int kk = 0; kk < 0; ++kk)\n"
         "        wgmma_m64nN_ss<FWD_ROWS>(")],
    "forward: the transpose pass alone (no main kernel)": [
        ("  dropout_fwd_kernel<TA, FORCED><<<grid, FWD_NT, smem, st>>>(\n"
         "      tm_x, tm_at, static_cast<const uint32_t*>(bits),\n"
         "      static_cast<float*>(out), sh);\n", "")],
    "forward: 2 consumer warpgroups": [
        ("constexpr int FWD_WG = 3;", "constexpr int FWD_WG = 2;")],
    "backward: a ring of at most 6 stages": [
        ("constexpr int BWD_MAX_STAGES = 4;", "constexpr int BWD_MAX_STAGES = 6;")],
    "backward: loads alone (x and g; no words, products or stores)": [
        ("      mbar_wait(full + 8 * s, (i / sh.stages) & 1);\n",
         "      mbar_wait(full + 8 * s, (i / sh.stages) & 1);\n"
         "      if (lane == 0) mbar_arrive(empty + 8 * s);\n"
         "      continue;  // ablation: the loads alone\n")],
    "backward: no dA products": [
        ("      for (int h = 0; h < 3; ++h)\n#pragma unroll\n"
         "        for (int kk = 0; kk < 4; ++kk)\n"
         "          wgmma_m64n64_ss<1, 1>(",
         "      for (int h = 0; h < 0; ++h)\n#pragma unroll\n"
         "        for (int kk = 0; kk < 4; ++kk)\n"
         "          wgmma_m64n64_ss<1, 1>(")],
    "backward: no dx chain (dx = 0 * m)": [
        ("      for (; j + 4 <= (sh.with_dx ? sh.mr : 0); j += 4) {",
         "      for (; j + 4 <= 0; j += 4) {"),
        ("      for (; j < (sh.with_dx ? sh.mr : 0); ++j) {",
         "      for (; j < 0; ++j) {")],
    "backward: no dx stores": [
        ("        tma_store_4d(&tm_dx, smem_addr(dxs), c0, n0, 0, 0, "
         "l2_evict_first());\n", "")]}


def fused_dropout_ablation_window() -> dict:
    """Kernels 6-7 with parts taken out (DROP_ABLATIONS: edited copies of
    fused_dropout.cu, built all at once) through the wrappers at N 4096,
    M*r 12, bf16 x and A, Philox, d 4096 and 11008: the forward and the
    backward alone (``graph_ms``), twice in turn; the unedited copy is
    first held against the plain versions (chip_smoke's DROP_TOL and one
    bf16 ulp for dx); then the generator's SASS (``philox_sass``)."""
    from chip_smoke import DROP_TOL
    from moka_tpu_torch.ops import fused_dropout as fd
    libs = {name: fd.bind(lib) for name, lib in
            finish_variants(start_variants("fused_dropout.cu",
                                           DROP_ABLATIONS)).items()}
    kept = fd._library()

    def install(lib):
        fd._lib = lib

    cases = {f"d {d}": dropout_case(d, 12) for d in (4096, 11008)}
    errs = {}
    for name, (x, a, gout, key) in cases.items():
        try:
            install(libs["kernel"])
            got = fd.dropout_a_fwd(x, a, key, 0.05)
            dx, _ = fd.dropout_a_bwd(x, a, gout, key, 0.05)
        finally:
            install(kept)
        ref = fd.dropout_a_fwd_plain(x, a, key, 0.05)
        rdx, _ = fd.dropout_a_bwd_plain(x, a, gout, key, 0.05)
        errs[name] = float((got - ref).abs().max() / ref.abs().max())
        ulp = float(((dx.float() - rdx.float()).abs()
                     - 2 ** -7 * rdx.float().abs()).max())
        print(f"  the unedited copy, {name}: out max|err| / max|plain| "
              f"{errs[name]:.2e} (tol {DROP_TOL}), dx beyond one ulp "
              f"{ulp:.2e}", flush=True)
        if errs[name] > DROP_TOL or ulp > 0:
            raise AssertionError("the ablation's unedited kernels are wrong")
        del got, dx, ref, rdx
    timers = {}
    for name, (x, a, gout, key) in cases.items():
        timers[f"fwd {name}"] = (lambda x=x, a=a, key=key: graph_ms(
            lambda: fd.dropout_a_fwd(x, a, key, 0.05), n=20))
        timers[f"bwd {name}"] = (lambda x=x, a=a, gout=gout, key=key:
                                 graph_ms(lambda: fd.dropout_a_bwd(
                                     x, a, gout, key, 0.05), n=20))
    out = swap_timed(install, kept, libs, timers)
    return {"fused_dropout_ablation": out, "dropout_rel_err": errs,
            "philox_sass": philox_sass()}


PHILOX_CHAIN = 16  # chained Philox calls in the probe's second kernel


def philox_sass() -> dict:
    """The SASS cost of one Philox4x32-10 call as fused_dropout.cu writes
    it: its ``philox`` function compiled into two probe kernels, one
    without a call and one with PHILOX_CHAIN chained calls; the
    difference over the chain is the instructions a call, and among them
    the 32-bit integer multiplies (IMAD*, IMUL*; a .WIDE one gives the
    high and low words: counted as two)."""
    import re
    from moka_tpu_torch import kernels
    src = (kernels.CSRC / "fused_dropout.cu").read_text()
    fn = src[src.index("struct RoundKeys {"):
             src.index("// the words of columns")]
    probe = ("#include <stdint.h>\n" + fn + """
extern "C" __global__ void philox_probe_0(
    uint32_t* out, const __grid_constant__ RoundKeys rk) {
  uint32_t w[4] = {threadIdx.x, blockIdx.x, rk.k0[0], rk.k1[0]};
  out[blockIdx.x * blockDim.x + threadIdx.x] = w[0] ^ w[1] ^ w[2] ^ w[3];
}
extern "C" __global__ void philox_probe_chain(
    uint32_t* out, const __grid_constant__ RoundKeys rk) {
  uint32_t w[4] = {threadIdx.x, blockIdx.x, rk.k0[0], rk.k1[0]};
#pragma unroll
  for (int i = 0; i < %d; ++i) philox(w[0] ^ w[2], w[1] ^ w[3], rk, w);
  out[blockIdx.x * blockDim.x + threadIdx.x] = w[0] ^ w[1] ^ w[2] ^ w[3];
}
""" % PHILOX_CHAIN)
    out_dir = kernels.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "philox_probe.cu"
    cu.write_text(probe)
    cubin = cu.with_suffix(".cubin")
    subprocess.run([kernels._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o",
                    str(cubin), str(cu)], check=True)
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn_name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn_name = m.group(1)
            counts[fn_name] = {"instructions": 0, "multiplies": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn_name and m and m.group(1) not in ("NOP", "BRA", "EXIT"):
            op = m.group(1)
            counts[fn_name]["instructions"] += 1
            if op.startswith(("IMAD", "IMUL")) and not op.startswith(
                    ("IMAD.MOV", "IMAD.IADD", "IMAD.SHL")):
                counts[fn_name]["multiplies"] += 2 if ".WIDE" in op else 1
    base = counts["philox_probe_0"]
    chain = counts["philox_probe_chain"]
    per_call = {k: (chain[k] - base[k]) / PHILOX_CHAIN for k in base}
    print(f"  Philox4x32-10 a call (SASS, {PHILOX_CHAIN} chained calls less "
          f"none): {per_call['instructions']:.2f} instructions, "
          f"{per_call['multiplies']:.2f} 32-bit multiplies", flush=True)
    return {"per_call": per_call, "counts": counts}


TRAIN_KEYS = {"full": "train_step", "fused": "train_step_fused_proj_lse",
              "quant": "train_step_quant_route_b",
              "rank": "train_step_flash_rank", "mm": "train_step_multimodal"}


GLOO_OPS = ("all_reduce", "broadcast", "all_gather",
            "all_gather_into_tensor", "send_recv")


def _gloo_op_rank(rank: int, op: str, out_dir: Path) -> None:
    """One rank of a 2-rank gloo world: collective ``op`` on a CUDA tensor
    as it is; writes what happened (a rank that aborts writes nothing)."""
    import torch
    import torch.distributed as dist
    t = torch.ones(4, device="cuda")
    run = {"all_reduce": lambda: dist.all_reduce(t.clone()),
           "broadcast": lambda: dist.broadcast(t.clone(), 0),
           "all_gather": lambda: dist.all_gather(
               [torch.empty_like(t) for _ in range(2)], t),
           "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
               t.new_empty(8), t),
           "send_recv": lambda: [r.wait() for r in dist.batch_isend_irecv([
               dist.P2POp(dist.isend, t.clone(), 1 - rank),
               dist.P2POp(dist.irecv, torch.empty_like(t), 1 - rank)])]}[op]
    try:
        run()
        torch.cuda.synchronize()
        what = "ok"
    except Exception as e:  # noqa: BLE001 - the reading is the error
        what = f"raised {type(e).__name__}: {str(e).splitlines()[0][:100]}"
    (out_dir / f"{op}.{rank}").write_text(what)


def gloo_cuda_window() -> dict:
    """Which gloo collectives take a CUDA tensor as it is, one 2-rank world
    a collective (all started together: an op that aborts a rank ends
    only its own world).  ``parallel.comm.transport`` follows the
    reading: gloo's sends get host copies, its other collectives CUDA
    tensors as they are."""
    import tempfile
    from moka_tpu_torch.parallel.mesh import start_world
    out_dir = Path(tempfile.mkdtemp(prefix="gloo_cuda_"))
    worlds = {op: start_world(_gloo_op_rank, 2, (op, out_dir))
              for op in GLOO_OPS}
    res = {}
    for op, ctx in worlds.items():
        try:
            while not ctx.join(timeout=120):
                pass
        except Exception as e:  # noqa: BLE001 - a rank died: the reading
            res[op] = f"world failed: {str(e).splitlines()[0][:120]}"
        got = [out_dir / f"{op}.{r}" for r in range(2)]
        res.setdefault(op, [f.read_text() if f.exists() else "no result"
                            for f in got])
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"gloo collectives on CUDA tensors: {res}", flush=True)
    return {"gloo_cuda": res}


DP_RANKS = 4  # the data-parallel mesh whose rank ``data_parallel`` emulates
DP_STEPS = 5  # timed steps, after two warm-up steps


def _dp_setup(device, mesh=None, batch_rows=None, view=None):
    """Phase 17 (c)'s step (7B widths at P17_FSDP_LAYERS layers, full
    remat, flash, chunked CE, dropout 0.05; ``chip_smoke.p17_mesh``) on
    ``batch_rows`` of its global batch of 4 x 1024 (all: None), with the
    dropout key's view ``view`` (a rank's rows) or none: (one step, the
    state's key)."""
    import dataclasses
    from chip_smoke import (P17_FSDP_LAYERS, _mesh_batch, build_model,
                            p17_configs)
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import make_optimizer
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    _, cfg, spec = p17_configs(False)
    cfg = dataclasses.replace(cfg, n_layers=P17_FSDP_LAYERS)
    frozen, adapters = build_model(cfg, spec, seed=3, device=device)
    batch = _mesh_batch(cfg, 4, 1024, device)
    if batch_rows is not None:
        batch = {k: (v[:, batch_rows] if k == "modality_masks" else
                     v[batch_rows]) for k, v in batch.items()}
    tx = make_optimizer(TrainConfig(), total_steps=1000)
    key = DropoutKey(0) if view is None else DropoutKey(0).rows(*view)
    state = init_train_state({"adapters": adapters}, tx, key)
    step = make_train_step(make_llama_moka_loss(
        cfg, spec, remat=True, use_flash=True, fused_loss=True, ce_chunk=128,
        mesh=mesh), tx, mesh=mesh)

    def one():
        nonlocal state
        state, m = step(state, frozen, batch)
        float(m["loss"])

    return one


def _dp_times(one) -> list:
    import torch
    for _ in range(2):
        one()
    out = []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _dp_rank(rank: int, out_dir: Path) -> None:
    """One rank of the NCCL world: the data-parallel step on its rows,
    timed; rank 0 traces one step."""
    import torch
    from moka_tpu_torch.core.config import MeshConfig
    from moka_tpu_torch.parallel.mesh import make_mesh
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    n = torch.distributed.get_world_size()
    rows = 4 // n
    one = _dp_setup("cuda", make_mesh(MeshConfig(n, 1, 1)),
                    slice(rank * rows, (rank + 1) * rows),
                    (0, rank * rows, 4))
    rec = {"step_ms": _dp_times(one)}
    # every rank takes the same steps: each step's collectives need all
    traced, ops, host = trace(one)
    wall = wall_ms(one)
    if rank == 0:
        rec["trace"] = summary(f"a rank of the {n},1,1 mesh (NCCL, one card "
                               f"a rank), {rows} of 4 rows", wall, traced,
                               ops, host=host)
    (out_dir / f"dp{rank}.json").write_text(json.dumps(rec))


def data_parallel_window() -> dict:
    """Why a rank of the data-parallel mesh (phase 17 (c), DP_RANKS,1,1)
    takes no less time than one process on the whole batch.  On one card,
    one process, no collectives: the step on the global batch (4 rows),
    on one row, and on one row with the dropout key's view of a rank's
    rows (what a rank of DP_RANKS computes); each timed over DP_STEPS
    steps, the last traced.  With several cards, the mesh itself in an
    NCCL world of one card a rank, each rank timed, rank 0 traced."""
    import tempfile
    import torch
    out = {}
    for name, rows, view in (("b4", None, None), ("b1", slice(0, 1), None),
                             ("b1_rank_view", slice(0, 1),
                              (0, 0, DP_RANKS))):
        one = _dp_setup("cuda", None, rows, view)
        times = _dp_times(one)
        traced, ops, host = trace(one)
        out[f"dp_{name}"] = dict(summary(
            f"phase 17 (c)'s step, one process, {name}", wall_ms(one),
            traced, ops, host=host), step_ms=times)
        print(f"  {name}: step ms {[round(t, 2) for t in times]}",
              flush=True)
        del one
        gc.collect()
        torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    if n > 1:
        from moka_tpu_torch.parallel.mesh import run_world
        out_dir = Path(tempfile.mkdtemp(prefix="dp_world_"))
        run_world(_dp_rank, n, (out_dir,), backend="nccl", timeout=300)
        out["dp_world"] = [json.loads((out_dir / f"dp{r}.json").read_text())
                           for r in range(n)]
        for r, rec in enumerate(out["dp_world"]):
            print(f"  rank {r} of {n}: step ms "
                  f"{[round(t, 2) for t in rec['step_ms']]}", flush=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    return out


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
                      "fused_ce_fwd_ablation": fused_ce_fwd_ablation_window,
                      "fused_ce_fwd_clocks": fused_ce_fwd_clocks_window,
                      "rank_kernels": rank_kernels_window,
                      "rank_ablation": rank_ablation_window,
                      "rank_bwd_ablation": rank_bwd_ablation_window,
                      "block_diag": block_diag_window,
                      "block_diag_ablation": block_diag_ablation_window,
                      "moka_delta": moka_delta_window,
                      "moka_ablation": moka_ablation_window,
                      "moka_prefill": moka_prefill_window,
                      "fused_dropout": fused_dropout_window,
                      "fused_dropout_ablation":
                          fused_dropout_ablation_window,
                      "dropout_dx_order": dropout_dx_order_window,
                      "paged_decode": decode_window,
                      "paged_decode_ablation": decode_ablation_window,
                      "gloo_cuda": gloo_cuda_window,
                      "data_parallel": data_parallel_window}
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
