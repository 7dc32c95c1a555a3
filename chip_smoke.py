#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``moka_tpu_torch``) on one H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, in order; any failed build, launch or check exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``moka_tpu_torch/kernels/csrc`` (nvcc,
     sm_90a, one process per source, in parallel) and, beside them, the
     deliberate faults RANK_MUTANTS and BD_MUTANTS (edited copies of the
     rank forward's and kernel 10's sources), print ptxas's resource
     lines and the SASS counts of the flash kernels, the fused CE pair,
     the rank kernels and kernel 10 (``cuobjdump -sass``: a forward
     instance, the dq kernel or a key-major backward kernel without HGMMA
     or UTMALDG or with HMMA, the fused backward without its bulk
     reduction, kernel 9 without HGMMA, UTMALDG or a bulk reduction or
     with HMMA, or an instance of kernel 10 without UTMALDG fails the
     phase; kernel 8 keeps mma.sync, the rank kernels are fp32 SIMT);
  3. each kernel against its plain PyTorch version on the card, with its
     time, the plain version's time, the library call's time (never called
     by the port: ``scaled_dot_product_attention``, forward, or forward +
     backward less forward for the three flash backward kernels;
     ``F.dropout(x) @ A`` for the fused dropout pair; the head's int8 ->
     bf16 cast, ``torch.matmul``, the scale and ``F.cross_entropy`` for the
     fused CE pair, kernel 9 against that forward's backward alone) and
     the least time
     the card could take (the bound); kernel 1 at head_dim 128 also at
     S % 128 != 0, non-causal with padded keys, on ring attention key
     shards at q_offset -200 and -512 and at q_offset -100 (query tile 0
     sees no key), every row that sees no key reading out 0 and lse <=
     -1e29, and launched with causal flipped it must fail the check (its
     yardstick: the faster of SDPA with the boolean mask and with
     is_causal); the three backward kernels also at S % 128 != 0,
     non-causal with padded keys, and on a ring attention key shard at a
     negative q_offset with the global rows' lse and delta (part of the
     shard visible; all of it masked, where dq, dk and dv must be exactly
     zero), and the fused and dq kernels launched with causal flipped
     must fail the check; the fused dropout kernels
     (6-7) in Philox and forced-words modes, masks held exactly; the fused CE
     kernels (8-9) on an int8 head at route B's shape and three ragged
     ones (kernel 9 also timed without the wrapper's zero fill and cast);
     the block-diagonal product (kernel 10) at the BOFT merge's three
     shapes, at b 16, 24 and 32 and with fp32 x, and launched as a mutant
     that reads each block transposed, which must fail (timed cold, x
     rotated past the L2 cache, and warm; library: ``torch.bmm``); the
     rank flash kernels (1-4 at head_dim 4, fp32) at the training step's
     (b 4, L 1024) with a sample that sees no key, on the forward's key
     layouts (a span in the last 256-key tile, one across a 256-key
     boundary, two spans, none; also at head_dim 16), causal at a
     q_offset that leaves rows before the first visible key, and at a
     ragged L, the backward on the forward kernel's lse; the forward
     launched as each mutant (it walks only the first visible 256-key
     tile; it gives 0 to a row that sees no key) must fail (timed: the
     wrapper back to back, the kernel alone in a CUDA graph, the host's
     µs a call); kernel 1 at the CLIP
     tower's shape (b*t 40 and 80 frames, 257 tokens, 16 heads, head_dim
     64, non-causal, every key valid) and a ragged one with padded keys
     (library: ``scaled_dot_product_attention`` without a mask);
  4. LLaMA-2-7B (bf16 base, random weights from a seed) with MokA AVT r=4
     adapters (B seeded non-zero) at full width and depth: the logits of
     ``greedy_generate``'s prefill of the whole batch through the kernels
     against the plain path, then ``greedy_generate`` timed for 1 and 32
     new tokens (the latter is the main path: launch counts are zeroed
     before it and read after);
  5. ``serve_continuous`` over a ``DecodeEngine``: three concurrent
     /generate requests of different prompt buckets and one
     /generate_stream request, each answered with its full token count;
  6. training (bench.py's 7B row with a bf16 base: vocab 32011, MokA AVT
     r=4 with dropout 0.05, full remat, flash, chunked CE, AdamW with
     warmup + cosine) at b 4, L 1024, full width and depth: the loss and
     every projection's adapter gradients through the kernels against the
     plain attention and an fp32 run, then 2 warm-up and 5 timed steps of
     ``make_train_step`` (launch counts zeroed before the timed steps and
     read after: 64 flash forward, 32 fused backward a step);
  7. one long-context step (b 1, L 4096, dynamic-NTK RoPE, full depth),
     which runs the dq + dkv backward pair (32 launches each);
  8. the fused-dropout step (phase 6's model and batch with bf16 dots,
     fused dropout and remat policy ``proj_lse``): at 2 layers the kernel
     path's gradients against the plain path (same Philox masks) and fp32,
     and proj_lse against full remat; then 2 warm-up and 5 timed steps
     (32 flash forward, 32 fused backward, 448 dropout forward and 224
     dropout backward launches a step), one traced step for the device's
     busy share (``profile_port.trace``), and one step under each of full,
     qkvod_lse, proj_nokv_lse and proj_lse (step time, peak memory);
  9. the shipping quantized recipe (``llama2_7b_int4a8_qh_sq8_plse``:
     int4 base and int8 head built on the card, a8_dots "full", save_q8,
     proj_lse, bf16 dots): at 2 layers route B's gradients (flash and the
     fused CE kernels 8-9) against the plain path and fp32; route B
     (``pallas_ce``) for 2 + 5 steps (32 flash forward, 32 fused backward,
     1 fused CE forward and 1 backward launch a step) with a traced step,
     route A (the chunked CE on the a8 head) for 1 + 3 (flash only), their
     first losses within the head's rounding;
 10. (run after phase 5, on its base) the BOFT merge: ``BoftSpec(8, 2)``
     adapters (Q ~ N(0, 0.1^2)) merged into all 224 projection weights by
     ``boft_weight(use_pallas=True)`` (448 launches of kernel 10,
     asserted; then once more traced) and by the plain einsum: layer 0's
     weights within one bf16
     ulp, every weight's column norms kept, then phase 4's prefill on the
     merged base against the plain path and fp32 on the plain-merged one;
 11. (run after phase 8, on phase 6's trees) the flash rank attention step:
     phase 6's step with ``with_flash_rank_attn()``: at 2 layers the rank
     kernels' gradients against the plain versions and fp32, and against
     the plain rank attention (the same math); at full depth 2 warm-up and
     3 timed steps (64 flash forward, 32 fused backward, 896 rank forward,
     448 rank dq and 448 rank dk/dv launches a step: full remat reruns
     every rank forward) with a traced step, and one ``proj_lse`` step
     (448 rank forwards: the policy keeps their residuals);
 12. (run after phase 9, on its int4 base, int8 head and adapters) the
     multimodal generate of ``bench_decode.py::main_mm`` on the stack
     ``avt_7b_int4a8f_qh_qenc_ta8f``: CLIP ViT-L/14 and BEATs built on the
     card and quantized to int8 (W8A8 dots; CLIP's attention through
     kernel 1 at head_dim 64), both Q-Former projectors and the splice, b
     8, 10 frames and 10 audio segments of 192 fbank frames a prompt:
     CLIP's last selected features through the kernel against the eager
     tower (TOWER_TOL, which the kernel run causal must fail), the prefill
     logits under phase 4's rule, then each stage timed and
     ``unified.generate`` for 1 and 32 new tokens (the latter the main
     path: 23 CLIP + 32 LLaMA flash forward and 224 fused MokA launches);
 13. the multimodal fine-tune step (``bench.py::run_multimodal`` on the
     same stack: qkvod_lse, a8_dots "full", the chunked CE on the a8
     head, b 4 x L 1024, the trainable tree {adapters, vl_projector,
     al_projector}): at 2 decoder layers with the full towers the loss and
     every adapter's and projector's gradients through the kernels against
     the plain path and fp32 (phase 6's rule), then 2 warm-up and 5 timed
     steps with a traced one (55 flash forward, 23 of them CLIP's, and 32
     fused backward launches a step);
 14. one JSON line with every kernel's numbers, then the card's line.
fp32 matmuls and convolutions run in full fp32 (TF32 off).  The script
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense tensor-core bf16
FP32_FLOPS = 67e12         # fp32 outside the tensor cores

FLASH_OUT_TOL = (4e-3, 2 ** -7)  # |d| <= atol + rtol*|plain| per element:
                      # both sides round P and out to bf16 (one ulp is 2^-8
                      # to 2^-7 relative) at different scales
FLASH_LSE_TOL = 1e-3  # fp32 lse, only the summation order differs
BWD_TOL = (2e-2, 1e-2)  # flash backward: max|err| as a fraction of
                      # max|plain|, and relative L2 error.  Both sides round p
                      # and ds to bf16 (2^-8 relative) at the same points but
                      # sum in other orders (the fused kernel's dq by TMA
                      # reductions in a varying order), and dq is rounded to
                      # bf16 at the end; a wrong mask, scale or skipped tile
                      # is O(1)
MOKA_TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # of max|plain|: one bf16
                      # rounding of the output (2^-8) / fp32 summation order
TRAIN_RATIO = 1.5  # training step: the kernel path's loss and per-projection
TRAIN_FLOOR = 1e-3  # adapter gradients may be up to 1.5x (+ 1e-3) as far
                    # from an fp32 run as the plain bf16 path's: both paths
                    # round the same activations to bf16 and differ only in
                    # where attention rounds p and ds
SHALLOW = 2  # layers of the second training-gradient check
REMAT_NOISE = (3.0, 1e-3)  # proj_lse vs full remat gradients, relative L2:
                 # at most 3x the spread of two full-remat runs (the fused
                 # flash backward adds dq over key tiles in a varying
                 # order: 1.3-2.6e-3 with the TMA reductions, PR 7) +
                 # 1e-3; both runs see the same masks and forward values
DROP_TOL = 1e-4  # fused dropout out and fp32 dA: max|err| as a fraction of
                 # max|plain|: fp32 sums over d (out) or N (dA) terms in
                 # another order, on exactly the same kept elements
DROP_DX_MISMATCH = 1e-2  # dx: share of bf16 elements that may differ from
                 # the plain version's, each by one ulp at most: g @ A^T sums
                 # its 12 terms in another order, which can move a rounding
LANE_INSTR = 33.5e12  # lane instructions a second: 132 SMs x 128 lanes x
                 # 1.98 GHz, the issue limit behind the 67 TFLOP/s fp32 peak
PHILOX_INSTR = 98  # integer instructions of one Philox4x32-10 call (four
                 # words): 10 rounds of 2 multiplies high and low and 4 xors,
                 # 9 key bumps of 2 adds
LOGIT_RATIO = 1.5  # prefill logits: the kernel path's distance from an fp32
                   # run may exceed the plain bf16 path's by half: both only
                   # round differently (+1e-3 / 1e-2 of the logit std)
CE_LSE_TOL = 1e-3  # fused CE nll and lse (nats, ~10.4 at V 32011): fp32 sums
                   # of exact bf16 x int8 products over d in another order
CE_DX_TOL = (2e-2, 1e-3)  # fused CE dx, both versions fed the plain lse:
                   # max|err| as a fraction of max|plain| and relative L2.
                   # Both round p to bf16 at the same point; the fp32 sums
                   # (logits over d, dx over V by TMA reductions) run in
                   # other orders, which can move a rounding of p or of dx
                   # by one bf16 ulp: 1.2e-4 rel L2 at the main shape
CE_SOFTMAX_TOL = 2e-2  # dx's L2 error over the norm of its softmax term
                   # (dx less the exact one-hot term, 2.4% of dx's norm at
                   # the main shape): sound 5.1-5.4e-3, p doubled on a
                   # quarter of the rows (``wrong_softmax``) 0.49-0.50
CE_GRAD_NOISE = (4.0, 1e-3)  # route B with kernels 8-9 against the same
                   # step with the plain CE, per projection over all layers:
                   # the int8 roundings of the cotangents turn one-ulp
                   # differences of dx into 0.5-2.7e-2 rel L2, 1.5-2.8x the
                   # spread of two kernel runs (flash's dq summed in a
                   # varying order; the TMA-reduced dq reads 1.2-1.6e-2 for
                   # q/k/v/o, 2.2-4.1e-3 for gate/up/down, PR 7)
CE_LAST_DOWN_TOL = 3e-3  # the same for the last layer's down adapter, whose
                   # cotangent reaches it with no int8 rounding: sound
                   # 1.2-1.5e-3, p doubled on a quarter of the rows 7.1-7.6e-3
HEAD_ROUTES_TOL = 1e-3  # route A's loss against route B's, relative: they
                   # differ only in the head product, h rounded to per-token
                   # int8 codes (1/127 of a row's max) against bf16


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak: float,
             *more_ops: tuple[float, float]) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' time; operations
    of other types, each at its own peak, are further (count, peak) pairs,
    and the slowest unit counts."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / p for n, p in ((n_ops, peak), *more_ops)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _wrappers() -> dict:
    """Every kernel wrapper by kernel name."""
    from moka_tpu_torch.ops import fbd
    from moka_tpu_torch.ops import flash_attention as fa
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops import fused_dropout as fd
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_fused": fa.flash_bwd_fused,
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "moka_delta_fwd": moka_delta_fused,
            "dropout_a_fwd": fd.dropout_a_fwd,
            "dropout_a_bwd": fd.dropout_a_bwd,
            "fused_ce_fwd": fc.fused_ce_fwd, "fused_ce_bwd": fc.fused_ce_bwd,
            "block_diag": fbd.block_diag_matmul,
            "flash_rank_fwd": fa.flash_rank_fwd,
            "flash_rank_bwd_dq": fa.flash_rank_bwd_dq,
            "flash_rank_bwd_dkv": fa.flash_rank_bwd_dkv}


def _counts() -> dict:
    """Launches by kernel name, and ``flash_fwd_hd64``: those of the flash
    forward at head_dim 64 (the CLIP tower), which ``flash_fwd`` counts
    too."""
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    out = {name: fn.launches for name, fn in _wrappers().items()}
    out["flash_fwd_hd64"] = flash_fwd.launches_by_head_dim.get(64, 0)
    return out


def _zero_counts() -> None:
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    for fn in _wrappers().values():
        fn.launches = 0
    flash_fwd.launches_by_head_dim.clear()


def _launches(**nonzero) -> dict:
    """The launch counts of a path: ``nonzero`` kernels, every other 0."""
    return {name: nonzero.get(name, 0)
            for name in (*_wrappers(), "flash_fwd_hd64")}


# ------------------------------------------------------------------ phase 2

SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "UBLKRED", "UTMAREDG", "HMMA")
FLASH_SASS = {"flash_fwd": ("flash_fwd_kernel", 2),  # library: function
              "flash_bwd": ("flash_bwd_dq_kernel", 1),  # stem, instances
              "flash_bwd_kv": ("flash_bwd_kv_kernel", 2)}


def sass_counts(name: str) -> dict:
    """Instruction counts by kernel function in library ``name``'s SASS
    (``cuobjdump -sass``): wgmma (HGMMA), TMA loads and stores (UTMALDG,
    UTMASTG), bulk and tensor reductions (UBLKRED, UTMAREDG) and mma.sync
    (HMMA)."""
    import re
    from moka_tpu_torch import kernels
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(kernels._target(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", line):
                counts[fn][op] += 1
    return counts


CE_SASS = ("fused_ce_bwd", "fused_ce_bwd_kernel")  # kernel 9: library,
                                                   # function stem


def check_ce_sass() -> dict:
    """Kernel 9 runs on wgmma and TMA: its one function shows HGMMA,
    UTMALDG and a bulk reduction (UBLKRED or UTMAREDG, dx) and no HMMA;
    kernel 8 (``fused_ce``) keeps mma.sync and is only printed.  Raises
    otherwise."""
    out = {}
    for lib in ("fused_ce", CE_SASS[0]):
        out[lib] = sass_counts(lib)
        for fn, c in out[lib].items():
            log(f"    {lib} SASS {fn}: " +
                ", ".join(f"{op} {k}" for op, k in c.items()))
    ks = [c for fn, c in out[CE_SASS[0]].items() if CE_SASS[1] in fn]
    if len(ks) != 1 or ks[0]["HGMMA"] == 0 or ks[0]["UTMALDG"] == 0 or \
            ks[0]["HMMA"] or ks[0]["UBLKRED"] + ks[0]["UTMAREDG"] == 0:
        raise AssertionError(f"fused CE backward SASS: lacks wgmma, TMA or "
                             f"its bulk reduction, or keeps mma.sync: "
                             f"{out[CE_SASS[0]]}")
    return out


BD_SASS = ("block_diag", "block_diag_kernel", 4)  # kernel 10: library,
                                                 # function stem, instances


def check_bd_rank_sass() -> dict:
    """Kernel 10 loads x by TMA: each of its four instances (bf16 and fp32
    x, b 8 and any b) shows UTMALDG; the rank flash kernels (fp32 SIMT)
    are only printed.  Raises otherwise."""
    out = {}
    for lib in ("flash_rank", BD_SASS[0]):
        out[lib] = sass_counts(lib)
        for fn, c in out[lib].items():
            log(f"    {lib} SASS {fn}: " +
                ", ".join(f"{op} {k}" for op, k in c.items()))
    ks = [c for fn, c in out[BD_SASS[0]].items() if BD_SASS[1] in fn]
    if len(ks) != BD_SASS[2] or any(c["UTMALDG"] == 0 for c in ks):
        raise AssertionError(f"block_diag SASS: an instance lacks its TMA "
                             f"loads: {out[BD_SASS[0]]}")
    return out


# Deliberate faults, each an edited copy of a kernel's source built beside
# the kernels in phase 2 (profile_port.start_variants) and swapped in for
# its library in phase 3, where each must fail the check it is run under.
RANK_MUTANTS = {  # flash_rank.cu's forward
    "walks only the first visible 256-key tile": [
        ("  const int end = causal ? min(hi, row + q_offset) : hi;",
         "  const int end = min(causal ? min(hi, row + q_offset) : hi,\n"
         "                      lo / 256 * 256 + 255);")],
    "gives 0 to a row that sees no key": [
        ("o[d] = vsum[d] / static_cast<float>(S);", "o[d] = 0.f;")]}
BD_MUTANTS = {  # block_diag.cu
    "reads the block transposed": [
        ("w[i8][j] = __ldg(bp + i8 * 8 + j);",
         "w[i8][j] = __ldg(bp + j * 8 + i8);")]}
MUTANT_SOURCES = {"flash_rank": ("flash_rank.cu", RANK_MUTANTS),
                  "block_diag": ("block_diag.cu", BD_MUTANTS)}
MUTANTS: dict = {}  # library name: {fault: loaded library}, after phase 2


@contextlib.contextmanager
def swapped_library(name, lib):
    """Within: the wrappers of library ``name`` launch ``lib``, an edited
    copy of its source."""
    from moka_tpu_torch.ops import fbd
    from moka_tpu_torch.ops import flash_attention as fa
    if name == "block_diag":
        kept = fbd._library()
        fbd._lib = fbd.bind(lib)
    else:
        kept = fa._library(name)
        fa._libs[name] = fa.bind(name, lib)
    try:
        yield
    finally:
        if name == "block_diag":
            fbd._lib = kept
        else:
            fa._libs[name] = kept


def check_flash_sass() -> dict:
    """Every flash kernel runs on wgmma and TMA: each instance of the
    forward (``flash_fwd_kernel<64>``, ``<128>``), the dq kernel and both
    key-major backward kernels show HGMMA and UTMALDG and no HMMA
    (mma.sync), and the fused one (``flash_bwd_kv_kernel<true>``, mangled
    ``...ILb1E...``) a bulk reduction; raises otherwise."""
    out = {}
    for lib, (stem, n) in FLASH_SASS.items():
        counts = sass_counts(lib)
        for fn, c in counts.items():
            log(f"    {lib} SASS {fn}: " +
                ", ".join(f"{op} {k}" for op, k in c.items()))
        ks = {fn: c for fn, c in counts.items() if stem in fn}
        fused = [c for fn, c in ks.items() if "ILb1E" in fn]
        if len(ks) != n or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 or
                               c["HMMA"] for c in ks.values()) or \
                (lib == "flash_bwd_kv" and (
                    len(fused) != 1 or
                    fused[0]["UBLKRED"] + fused[0]["UTMAREDG"] == 0)):
            raise AssertionError(f"{lib} SASS: a kernel lacks wgmma or TMA, "
                                 f"keeps mma.sync, or the fused backward "
                                 f"lacks its bulk reduction: {counts}")
        out[lib] = counts
    return out


# ------------------------------------------------------------------ phase 3

def _visible(mask, L, S, q_offset, causal=True):
    """(b, L, S) bool: padding visibility, and causal with ``causal``."""
    import torch
    ok = (mask[:, None, :] > 0).expand(-1, L, -1)
    if not causal:
        return ok
    qpos = torch.arange(L, device=mask.device)[:, None] + q_offset
    return (qpos >= torch.arange(S, device=mask.device)[None, :])[None] & ok


def flash_case(b, H, KH, L, S, pads=None, seed=0, hd=128):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, L, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, S, KH, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, S, KH, hd), generator=g, device="cuda").bfloat16()
    mask = torch.ones((b, S), dtype=torch.int32, device="cuda")
    for i, p in enumerate(pads or ()):
        mask[i, :p] = 0
    return q, k, v, mask


SAME_FUNCTION_TOL = 5e-2  # a library call against the plain version: it
                  # scales the scores in fp32, not q in bf16, so its P moves
                  # by ~2^-8 of a score; a misplaced diagonal moves the first
                  # rows (a few keys each) by O(1)
DEAD_LSE = -1e29  # the lse of a row that sees no key: -1e30 ln 2 from the
                  # kernel, (-1e30 + log2 S) ln 2 from the plain version


def check_flash(name, q, k, v, mask, q_offset=0, causal=True) -> float:
    """Kernel 1 against ``flash_fwd_plain`` on the rows that see a key
    (FLASH_OUT_TOL, FLASH_LSE_TOL); a row that sees no key must read out
    exactly 0 and lse <= DEAD_LSE (the plain version averages V there)."""
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    import torch
    out, lse = flash_fwd(q, k, v, mask, q_offset, causal)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_plain(q, k, v, mask, q_offset, causal)
    L, S = q.shape[1], k.shape[1]
    rows = _visible(mask, L, S, q_offset, causal).any(dim=-1)  # valid rows
    atol, rtol = FLASH_OUT_TOL
    diff = (out.float() - ref.float()).abs() * rows[:, :, None, None]
    excess = float((diff - rtol * ref.float().abs()).max())
    d_out = float(diff.max())
    d_lse = float(((lse - ref_lse).abs().amax(dim=1) * rows).max())
    dead = ~rows
    dead_ok = bool((out[dead] == 0).all()) and \
        bool((lse.transpose(1, 2)[dead] <= DEAD_LSE).all())
    ok = excess <= atol and d_lse <= FLASH_LSE_TOL and dead_ok
    log(f"  flash {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"q_offset {q_offset} causal {causal}: max|out err| {d_out:.3e}, "
        f"max(|err| - "
        f"{rtol:.4g}|plain|) {excess:.3e} (tol {atol}), max|lse err| "
        f"{d_lse:.3e} (tol {FLASH_LSE_TOL}), valid rows "
        f"{int(rows.sum())}/{rows.numel()}, rows that see no key out 0 and "
        f"lse <= {DEAD_LSE:g}: {dead_ok}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version "
                             f"({name})")
    return d_out


@contextlib.contextmanager
def flipped_causal_fwd():
    """Within: every flash forward launch runs its kernel with the causal
    flag flipped (a deliberate fault)."""
    from moka_tpu_torch.ops import flash_attention as fa
    launch = fa._launch_fwd

    def wrong(q, k, v, attn_mask, q_offset, causal):
        return launch(q, k, v, attn_mask, q_offset, not causal)

    fa._launch_fwd = wrong
    try:
        yield
    finally:
        fa._launch_fwd = launch


def must_fail(what, check) -> None:
    """Run ``check`` (a deliberate fault): it must raise AssertionError."""
    try:
        check()
    except AssertionError as e:
        log(f"  the fault fails the check, as it must: {e}")
    else:
        raise AssertionError(f"{what} passed the check")


def flash_record(b, L, S) -> dict:
    """Check kernel 1 at head_dim 128 at the checked shapes (ragged S,
    padding, GQA, positive and negative query offsets: ring attention's key
    shards, and a query tile that sees no key) and time it at the main
    path's prefill shape (b, L, S).  The library yardstick is the faster of
    two ``scaled_dot_product_attention`` calls that compute the same
    function there: with the boolean mask, and ``is_causal`` without one
    on the first L keys (every key is valid and q_offset is 0, so query i
    sees keys <= i < L; its output is checked against the plain
    version)."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    err = 0.0
    for name, shape, kw in (
            ("slice shape", (8, 32, 32, 896, 1024), {}),
            ("GQA 32:8", (2, 32, 8, 512, 512), {"seed": 1}),
            ("q_offset", (2, 32, 32, 128, 1024), {"seed": 2,
                                                  "q_offset": 896}),
            ("left pad + ragged L", (4, 32, 32, 333, 333),
             {"seed": 3, "pads": (0, 17, 64, 100)}),
            ("S % 128 != 0", (2, 32, 32, 1000, 1000), {"seed": 8}),
            ("non-causal, left pad", (2, 32, 8, 333, 333),
             {"seed": 9, "pads": (0, 100), "causal": False}),
            ("key shard, q_offset -200", (2, 32, 32, 512, 512),
             {"seed": 10, "q_offset": -200}),
            ("masked shard, q_offset -512", (2, 32, 32, 512, 512),
             {"seed": 11, "q_offset": -512}),
            ("query tile 0 sees no key, q_offset -100",
             (2, 32, 32, 256, 256), {"seed": 12, "q_offset": -100})):
        kw = dict(kw)
        qo, causal = kw.pop("q_offset", 0), kw.pop("causal", True)
        err = max(err, check_flash(name, *flash_case(*shape, **kw), qo,
                                   causal))
    # fault injection: the kernel launched with causal flipped
    case = flash_case(2, 32, 8, 512, 512, seed=1)
    with flipped_causal_fwd():
        must_fail("the flash forward with causal flipped",
                  lambda: check_flash("causal flipped (a deliberate fault)",
                                      *case))
    del case
    q, k, v, mask = flash_case(b, 32, 32, L, S, seed=4)
    err = max(err, check_flash("main path shape", q, k, v, mask))
    ms = time_ms(lambda: flash_fwd(q, k, v, mask))
    plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, mask))
    # the wrapper's host time a call: launches enqueued back to back (the
    # queue stays short of full), host clock, no synchronise inside
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        flash_fwd(q, k, v, mask)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    vis = _visible(mask, L, S, 0)
    bool_mask = vis[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_mask_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bool_mask))
    # is_causal takes the keys some query sees (the first L: q_offset is
    # 0), so that L == S leaves no doubt where its diagonal lies
    ks, vs = kt[:, :, :L], vt[:, :, :L]
    ref = flash_fwd_plain(q, k, v, mask)[0]
    causal_out = F.scaled_dot_product_attention(qt, ks, vs, is_causal=True)
    d_causal = float((causal_out.transpose(1, 2).float() - ref.float()).abs()
                     .max())
    same = d_causal <= SAME_FUNCTION_TOL
    lib_causal_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, ks, vs, is_causal=True))
    del ref, causal_out
    lib_ms = min(lib_mask_ms, lib_causal_ms) if same else lib_mask_ms
    H, KH, hd = q.shape[2], k.shape[2], q.shape[3]
    pairs = float(vis.sum()) * H
    # bytes: q read and out written whole, the lse written, and only the
    # key positions some query can see read from k, v and the mask (the
    # kernel skips tiles wholly above the diagonal)
    seen = int(vis.any(dim=1).sum())
    kv_bytes = seen * (2 * KH * hd * k.element_size() + mask.element_size())
    lse_bytes = b * H * L * 4
    bms, by = bound_ms(2 * nbytes(q) + kv_bytes + lse_bytes,
                       4.0 * hd * pairs, BF16_FLOPS)
    log(f"  flash timing at (b {b}, H 32, L {L}, S {S}, hd 128): kernel "
        f"{ms:.4f} ms (host {host_us:.1f} us a call), plain {plain_ms:.4f} "
        f"ms, sdpa with the boolean mask {lib_mask_ms:.4f} ms, sdpa "
        f"is_causal {lib_causal_ms:.4f} ms (max|out - plain| {d_causal:.3e},"
        f" same function: {same}), bound "
        f"{bms:.4f} ms ({by})")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "moka_tpu/ops/flash_attention.py:56",
            "launches": None, "max_abs_err": err,
            "tolerance": "|err| <= %g + %g |plain|" % FLASH_OUT_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_mask_ms": lib_mask_ms,
            "library_is_causal_ms": lib_causal_ms,
            "is_causal_same_function": same, "host_us": host_us,
            "library": "the faster of scaled_dot_product_attention with the "
                       "boolean mask and with is_causal",
            "shape": f"b {b} H 32 L {L} S {S} hd 128, one layer"}


CLIP_FRAMES = (40, 80)  # b*t frames of the step (b 4) and of generate (b 8)


def clip_flash_record() -> dict:
    """Kernel 1 at the CLIP tower's shape: (b*t, 257, 16, 64), non-causal,
    every key valid, at both paths' frame counts, and a ragged case with
    padded keys; timed at both (the record's times at 80 frames, the
    serving path's)."""
    import torch.nn.functional as F
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    err = check_flash("CLIP ragged, padded keys", *flash_case(
        4, 16, 16, 257, 200, seed=6, hd=64, pads=(0, 3, 64, 199)),
        causal=False)
    timed = {}
    for frames in CLIP_FRAMES:
        q, k, v, mask = flash_case(frames, 16, 16, 257, 257, seed=5, hd=64)
        err = max(err, check_flash(f"CLIP, {frames} frames", q, k, v, mask,
                                   causal=False))
        ms = time_ms(lambda: flash_fwd(q, k, v, mask, causal=False))
        plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, mask,
                                                   causal=False))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        b, L, H, hd = q.shape
        pairs = float(b * H * L * L)
        bms, by = bound_ms(4 * nbytes(q) + nbytes(mask) + b * H * L * 4,
                           4.0 * hd * pairs, BF16_FLOPS)
        timed[frames] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by}
        log(f"  flash timing at the CLIP shape (b {b}, H 16, L 257, hd 64, "
            f"non-causal): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del q, k, v, mask, qt, kt, vt
    return {"name": "flash_fwd_hd64", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "moka_tpu/ops/flash_attention.py:56",
            "launches": None, "max_abs_err": err,
            "tolerance": "|err| <= %g + %g |plain|" % FLASH_OUT_TOL,
            **timed[CLIP_FRAMES[-1]], "by_frames": timed,
            "shape": f"b {CLIP_FRAMES[-1]} H 16 L 257 S 257 hd 64, "
                     f"non-causal, one CLIP layer"}


def bwd_case(b, H, KH, L, S, pads=None, q_offset=0, seed=0, causal=True):
    """Inputs of the backward kernels: the forward kernel's own out and lse
    on random bf16 q, k, v, a random dO and delta = rowsum(dO * out)."""
    import torch
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    q, k, v, mask = flash_case(b, H, KH, L, S, pads, seed)
    out, lse = flash_fwd(q, k, v, mask, q_offset, causal)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    return (q, k, v, mask, dout, lse, delta.contiguous()), q_offset


def shard_case(b, H, KH, L, S, q_offset, seed=0):
    """Inputs of the backward kernels on one key shard of ring attention:
    the queries sit at global positions [S + q_offset, ...), the keys of a
    preceding shard of S at [0, S) and this shard's at [S, 2 S), so lse
    and delta are the global rows' (the forward kernel over both shards)
    and every query row sees a key; this shard's ``q_offset`` is the one
    given (negative: part or all of the shard lies above the diagonal, so
    the mask and not the lse must zero p there)."""
    import torch
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    q, k, v, mask = flash_case(b, H, KH, L, 2 * S, seed=seed)
    out, lse = flash_fwd(q, k, v, mask, S + q_offset)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    k, v, mask = (t[:, S:].contiguous() for t in (k, v, mask))
    return (q, k, v, mask, dout, lse, delta.contiguous()), q_offset


@contextlib.contextmanager
def flipped_causal_bwd():
    """Within: every flash backward launch runs its kernel with the causal
    flag flipped (a deliberate fault)."""
    from moka_tpu_torch.ops import flash_attention as fa
    launch = fa._launch_bwd

    def wrong(which, q, k, v, attn_mask, dout, lse, delta, q_offset, causal):
        return launch(which, q, k, v, attn_mask, dout, lse, delta, q_offset,
                      not causal)

    fa._launch_bwd = wrong
    try:
        yield
    finally:
        fa._launch_bwd = launch


def check_flash_bwd(name, which, args, q_offset, causal=True) -> float:
    """One backward kernel against ``flash_bwd_plain`` on the same inputs:
    every output within BWD_TOL, and exact zeros on the rows of queries
    that see no key and of keys that no query sees."""
    import torch
    from moka_tpu_torch.ops import flash_attention as fa
    fn = {"fused": fa.flash_bwd_fused, "dq": fa.flash_bwd_dq,
          "dkv": fa.flash_bwd_dkv}[which]
    got = fn(*args, q_offset, causal)
    got = (got,) if which == "dq" else got
    torch.cuda.synchronize()
    ref = fa.flash_bwd_plain(*args, q_offset, causal)
    ref = {"fused": ref, "dq": ref[:1], "dkv": ref[1:]}[which]
    names = {"fused": ("dq", "dk", "dv"), "dq": ("dq",),
             "dkv": ("dk", "dv")}[which]
    q, mask = args[0], args[3]
    vis = _visible(mask, q.shape[1], mask.shape[1], q_offset, causal)
    dead = {"dq": ~vis.any(dim=-1), "dk": ~vis.any(dim=1),
            "dv": ~vis.any(dim=1)}  # (b, L) / (b, S)
    frac, l2_tol = BWD_TOL
    worst, msgs = 0.0, []
    for n, x, y in zip(names, got, ref):
        x, y = x.float(), y.float()
        d = float((x - y).abs().max())
        scale = float(y.abs().max())
        ref_norm = float(y.norm())  # 0 on a shard no query sees: then
        rel_l2 = (float((x - y).norm() / ref_norm) if ref_norm else  # exact
                  (0.0 if bool((x == 0).all()) else math.inf))
        zeros = bool((x[dead[n]] == 0).all())
        part = d / scale if scale else (0.0 if d == 0 else math.inf)
        msgs.append(f"{n} max|err| {d:.3e} ({part:.2e} of max|plain|),"
                    f" rel L2 {rel_l2:.2e}, dead rows zero {zeros}")
        if not (d <= frac * scale and rel_l2 <= l2_tol and zeros):
            raise AssertionError(f"flash backward {which} disagrees with its "
                                 f"plain version ({name}): {msgs[-1]}")
        worst = max(worst, d)
    log(f"  flash bwd {which} {name}: q {tuple(q.shape)} k "
        f"{tuple(args[1].shape)} q_offset {q_offset}: " + "; ".join(msgs) +
        f" (tol {frac} of max|plain|, rel L2 {l2_tol})")
    return worst


def flash_bwd_records() -> list[dict]:
    """Check the three backward kernels (main-path shapes, GQA, left
    padding with ragged L, a query offset, S % 128 != 0, ring key shards
    at negative offsets, non-causal with padding; the fused and dq kernels
    with causal flipped must fail) and time each at its main-path shape:
    fused at (b 4, H 32, L 1024), dq and dkv at (b 1, H 32, L 4096), the
    training steps' shapes."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import flash_attention as fa
    errs = {"fused": 0.0, "dq": 0.0, "dkv": 0.0}
    cases = [("main path shape", "fused", (4, 32, 32, 1024, 1024), {}),
             ("GQA 32:8", "fused", (2, 32, 8, 512, 512), {"seed": 1}),
             ("left pad + ragged L", "fused", (4, 32, 32, 333, 333),
              {"seed": 2, "pads": (0, 17, 64, 100)}),
             ("q_offset", "fused", (2, 32, 32, 128, 1024),
              {"seed": 3, "q_offset": 896})]
    for which in ("fused", "dkv", "dq"):  # ragged S, shards, padding
        cases += [("S % 128 != 0", which, (2, 32, 32, 1000, 1000),
                   {"seed": 5}),
                  ("key shard, q_offset -200", which,
                   (2, 32, 32, 512, 512), {"seed": 6, "q_offset": -200}),
                  ("masked shard, q_offset -512", which,
                   (2, 32, 32, 512, 512), {"seed": 7, "q_offset": -512}),
                  ("non-causal, left pad", which, (2, 32, 8, 333, 333),
                   {"seed": 8, "pads": (0, 100), "causal": False})]
    for which in ("dq", "dkv"):
        cases += [("main path shape", which, (1, 32, 32, 4096, 4096), {}),
                  ("GQA 32:8", which, (2, 32, 8, 512, 512), {"seed": 1}),
                  ("left pad + ragged L", which, (4, 32, 32, 1333, 1333),
                   {"seed": 2, "pads": (0, 17, 64, 700)}),
                  ("q_offset", which, (2, 32, 32, 1100, 2048),
                   {"seed": 3, "q_offset": 948})]
    for name, which, shape, kw in cases:
        if kw.get("q_offset", 0) < 0:
            args, qo = shard_case(*shape, kw["q_offset"], kw["seed"])
        else:
            args, qo = bwd_case(*shape, **kw)
        errs[which] = max(errs[which], check_flash_bwd(
            name, which, args, qo, kw.get("causal", True)))
        del args
    # fault injection: the fused and the dq kernel launched with causal
    # flipped
    args, qo = bwd_case(2, 32, 8, 512, 512, seed=1)
    for which in ("fused", "dq"):
        with flipped_causal_bwd():
            must_fail(f"the {which} backward with causal flipped",
                      lambda: check_flash_bwd(
                          "causal flipped (a deliberate fault)", which, args,
                          qo))
    del args
    records = []
    for which, shape, products, tpu_line in (
            ("fused", (4, 32, 32, 1024, 1024), 5, 230),
            ("dq", (1, 32, 32, 4096, 4096), 3, 136),
            ("dkv", (1, 32, 32, 4096, 4096), 4, 180)):
        args, qo = bwd_case(*shape, seed=4)
        q, k, v, mask, dout = args[:5]
        fn = {"fused": fa.flash_bwd_fused, "dq": fa.flash_bwd_dq,
              "dkv": fa.flash_bwd_dkv}[which]
        ms = time_ms(lambda: fn(*args, qo))
        plain_ms = time_ms(lambda: fa.flash_bwd_plain(*args, qo), iters=3,
                           warmup=1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        dt = dout.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dt)

        lib_ms = time_ms(sdpa_fwd_bwd) - time_ms(sdpa)
        b, L, H, hd = q.shape
        vis = _visible(mask, L, k.shape[1], qo)
        pairs = float(vis.sum()) * H
        seen = int(vis.any(dim=1).sum())
        kv_bytes = seen * (2 * k.shape[2] * hd * k.element_size()
                           + mask.element_size())
        rows = b * H * L * 4 * 2  # lse and delta
        outs = {"fused": nbytes(q) + 2 * seen * k.shape[2] * hd * 4,
                "dq": nbytes(q), "dkv": 2 * seen * k.shape[2] * hd * 4}
        n_bytes = 2 * nbytes(q) + kv_bytes + rows + outs[which]
        bms, by = bound_ms(n_bytes, products * 2.0 * hd * pairs, BF16_FLOPS)
        log(f"  flash bwd {which} timing at (b {b}, H {H}, L {L}, S "
            f"{k.shape[1]}, hd {hd}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        passes = {}  # the wrapper's passes around the key-major kernels
        if which != "dq":
            passes["prescale_q"] = time_ms(lambda: fa._prescaled(q))
        if which == "fused":
            ws = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            passes["zero_dq"] = time_ms(lambda: torch.zeros_like(ws))
            passes["cast_dq"] = time_ms(lambda: ws.to(q.dtype))
            del ws
        if passes:
            log(f"    of which the wrapper's passes: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in passes.items()))
        records.append({
            "name": f"flash_bwd_{which}", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/" +
                      ("flash_bwd.cu" if which == "dq" else "flash_bwd_kv.cu"),
            "replaces": f"moka_tpu/ops/flash_attention.py:{tpu_line}",
            "launches": None, "max_abs_err": errs[which],
            "tolerance": "max|err| <= %g max|plain|, rel L2 <= %g" % BWD_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "wrapper_passes_ms": passes,
            "library": "scaled_dot_product_attention(is_causal) forward + "
                       "backward less forward (all three gradients)",
            "shape": f"b {b} H {H} L {L} S {k.shape[1]} hd {hd}, one layer"})
        del args, qt, kt, vt
    return records


def moka_inputs(b, L, d_in, d_out, flavour, dtype, seed):
    import torch
    from moka_tpu_torch.ops.moka import MokaSpec
    g = torch.Generator(device="cuda").manual_seed(seed)
    spec = (MokaSpec.avt(rank=4, dropout_rate=0.0) if flavour == "avt"
            else MokaSpec.vt(rank=4, dropout_rate=0.0))
    M = spec.num_modalities
    x = torch.randn((b, L, d_in), generator=g, device="cuda").to(dtype)
    bound = 1.0 / math.sqrt(d_in)
    a = torch.rand((M, d_in, 4), generator=g, device="cuda") * 2 * bound \
        - bound
    bm = torch.randn((4, d_out), generator=g, device="cuda") * 0.02
    mod, qm = avt_masks(b, L, M)
    return x, a, bm, mod, qm, spec


def mm_prefill_checks(records, new_tokens=32) -> None:
    """Kernels 1 and 5 at the exact prefill shape of phase 12's batch
    (``mm_batch(mm_config(), 8)``: its length, its own left pads, its
    modality and question masks), on random q/k/v, x, A and B, against
    their plain versions under phase 3's limits; the records' max_abs_err
    take the larger error."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    ucfg = mm_config()
    cfg, spec = ucfg.llama, ucfg.spec
    batch = mm_batch(ucfg, 8)
    pmask = batch["attn_mask"]
    b, L = pmask.shape
    pads = [int(p) for p in (pmask == 0).sum(dim=1)]
    log(f"  phase 12's prefill batch: b {b} L {L}, left pads {pads}")
    q, k, v, _ = flash_case(b, cfg.n_heads, cfg.n_kv_heads, L,
                            L + new_tokens, seed=7)
    mask = F.pad(pmask, (0, new_tokens))
    err = check_flash("multimodal prefill", q, k, v, mask)
    del q, k, v
    rec = {r["name"]: r for r in records}
    rec["flash_fwd"]["max_abs_err"] = max(rec["flash_fwd"]["max_abs_err"],
                                          err)
    mod, qm = batch["modality_masks"], batch["question_mask"]
    g = torch.Generator(device="cuda").manual_seed(21)
    for d_in, d_out in sorted({(cfg.dim, cfg.dim),
                               (cfg.dim, cfg.intermediate),
                               (cfg.intermediate, cfg.dim)}):
        x = torch.randn((b, L, d_in), generator=g,
                        device="cuda").bfloat16()
        bound = 1.0 / math.sqrt(d_in)
        a = torch.rand((3, d_in, spec.rank), generator=g,
                       device="cuda") * 2 * bound - bound
        bm = torch.randn((spec.rank, d_out), generator=g,
                         device="cuda") * 0.02
        got = moka_delta_fused(x, a, bm, mod, qm, spec)
        torch.cuda.synchronize()
        ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
        scale = float(ref.float().abs().max())
        d = float((got.float() - ref.float()).abs().max())
        tol = MOKA_TOL["bfloat16"]
        log(f"  moka multimodal prefill bf16 {d_in}->{d_out}: max|err| "
            f"{d:.3e}, max|plain| {scale:.3e}, rel {d / scale:.3e} (tol "
            f"{tol})")
        if not d <= tol * scale:
            raise AssertionError("fused MokA kernel disagrees with its plain "
                                 "version at phase 12's prefill masks")
        rec["moka_delta_fwd"]["max_abs_err"] = max(
            rec["moka_delta_fwd"]["max_abs_err"], d)
    del batch


def avt_masks(b, L, M, n_valid=None):
    """bench_decode's layout: text / video / audio = 1/2, 1/4, 1/4 of the
    prompt (VT: text / image = 1/2, 1/2), question span [2, 130)."""
    import torch
    n = L if n_valid is None else n_valid
    mod = torch.zeros((M, b, L), dtype=torch.float32, device="cuda")
    mod[0, :, : n // 2] = 1
    if M == 3:
        mod[1, :, n // 2: 3 * n // 4] = 1
        mod[2, :, 3 * n // 4: n] = 1
    else:
        mod[1, :, n // 2: n] = 1
    qm = torch.zeros((b, L), dtype=torch.float32, device="cuda")
    qm[:, 2: min(130, n // 2)] = 1
    return mod, qm


def moka_record(b, L, dim, inter) -> dict:
    import torch
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    shapes = {"q": (dim, dim), "k": (dim, dim), "v": (dim, dim),
              "o": (dim, dim), "gate": (dim, inter), "up": (dim, inter),
              "down": (inter, dim)}
    err = 0.0
    for i, (d_in, d_out) in enumerate(sorted(set(shapes.values()))):
        for flavour in ("avt", "vt"):
            for dtype in (torch.bfloat16, torch.float32):
                x, a, bm, mod, qm, spec = moka_inputs(b, L, d_in, d_out,
                                                      flavour, dtype, 10 + i)
                got = moka_delta_fused(x, a, bm, mod, qm, spec)
                torch.cuda.synchronize()
                ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
                scale = float(ref.float().abs().max())
                d = float((got.float() - ref.float()).abs().max())
                tol = MOKA_TOL[str(dtype).split(".")[1]]
                log(f"  moka {flavour} {str(dtype)[6:]} {d_in}->{d_out}: "
                    f"max|err| {d:.3e}, max|plain| {scale:.3e}, "
                    f"rel {d / scale:.3e} (tol {tol})")
                if not d <= tol * scale:
                    raise AssertionError("fused MokA kernel disagrees with "
                                         "its plain version")
                if dtype == torch.bfloat16 and flavour == "avt":
                    err = max(err, d)
    ms = plain_ms = bms = ops_total = bytes_total = 0.0
    for name, (d_in, d_out) in shapes.items():
        x, a, bm, mod, qm, spec = moka_inputs(b, L, d_in, d_out, "avt",
                                              torch.bfloat16, 20)
        t = time_ms(lambda: moka_delta_fused(x, a, bm, mod, qm, spec))
        tp = time_ms(lambda: moka_delta_fused_plain(x, a, bm, mod, qm, spec))
        n_b = nbytes(x, a, bm, mod, qm) + b * L * d_out * x.element_size()
        nq = float(qm.sum(dim=-1).max())
        n_ops = (2.0 * b * L * d_in * 3 * 4 + 2.0 * b * L * 4 * d_out
                 + 2 * 4.0 * b * L * nq * 4)
        one, by = bound_ms(n_b, n_ops, FP32_FLOPS)
        log(f"  moka timing {name} {d_in}->{d_out} (b {b}, L {L}, bf16, "
            f"AVT): kernel {t:.4f} ms, plain {tp:.4f} ms, bound {one:.4f} ms "
            f"({by})")
        ms, plain_ms, bms = ms + t, plain_ms + tp, bms + one
        ops_total += n_ops
        bytes_total += n_b
    _, by = bound_ms(bytes_total, ops_total, FP32_FLOPS)
    return {"name": "moka_delta_fwd", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/moka_delta_fwd.cu",
            "replaces": "moka_tpu/ops/moka_pallas.py:35",
            "launches": None, "max_abs_err": err,
            "tolerance": MOKA_TOL["bfloat16"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"b {b} L {L} bf16 AVT r4, one layer: the seven "
                     f"projections summed"}


DROP_RATE = 0.05   # the training path's LoRA dropout
DROP_MR = 12       # M * r of MokA AVT at rank 4


def dropout_case(n, d, x_dtype, a_dtype, forced, seed):
    """Inputs of the fused-dropout kernels: random x (n, d), A (d, 12)
    kaiming-uniform, a cotangent g (n, 12) fp32, a key, and (forced mode)
    random 32-bit words."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=g, device="cuda").to(x_dtype)
    bound = 1.0 / math.sqrt(d)
    a = (torch.rand((d, DROP_MR), generator=g, device="cuda") * 2 - 1) \
        * bound
    gout = torch.randn((n, DROP_MR), generator=g, device="cuda")
    bits = torch.randint(0, 1 << 32, (n, d), generator=g, device="cuda",
                         dtype=torch.int64) if forced else None
    return x, a.to(a_dtype), gout, DropoutKey(1000 + seed), bits


def check_dropout(name, x, a, gout, key, bits) -> float:
    """Kernels 6 and 7 against ``dropout_a_fwd_plain`` /
    ``dropout_a_bwd_plain`` on the same words: out and dA within DROP_TOL
    (fp32 sums in another order; a bf16 dA within one bf16 ulp), dx within
    one bf16 ulp and bit-identical on all but DROP_DX_MISMATCH of its
    elements, dx's zeros exactly the plain mask, two calls bit-identical,
    the forward's mask the backward's (the kernel's out equals the plain
    forward over dx's non-zero pattern), the keep share within 5 sigma."""
    import torch
    from moka_tpu_torch.ops import fused_dropout as fd
    n, d = x.shape
    runs = []
    for _ in range(2):
        out = fd.dropout_a_fwd(x, a, key, DROP_RATE, bits)
        dx, da = fd.dropout_a_bwd(x, a, gout, key, DROP_RATE, bits)
        runs.append((out, dx, da))
    torch.cuda.synchronize()
    (out, dx, da), again = runs
    same = all(torch.equal(p, q) for p, q in zip(runs[0], again))
    ref = fd.dropout_a_fwd_plain(x, a, key, DROP_RATE, bits)
    rdx, rda = fd.dropout_a_bwd_plain(x, a, gout, key, DROP_RATE, bits)
    words = bits if bits is not None else key.bits32((n, d), x.device)
    keep = words < fd.threshold(DROP_RATE)
    kept = dx != 0
    pattern = torch.equal(kept, keep)
    share = float(kept.float().mean())
    sigma = math.sqrt(DROP_RATE * (1 - DROP_RATE) / kept.numel())
    own = torch.where(kept, 0, (1 << 32) - 1)
    out_own = fd.dropout_a_fwd_plain(x, a, key, DROP_RATE, own)

    def frac(p, q):
        return float((p.float() - q.float()).abs().max() /
                     q.float().abs().max())

    e_out, e_own = frac(out, ref), frac(out, out_own)
    dxf, rdxf = dx.float(), rdx.float()
    ulp = float(((dxf - rdxf).abs() - 2 ** -7 * rdxf.abs()).max())
    mism = float((dx != rdx).float().mean())
    if da.dtype == torch.bfloat16:
        e_da = float(((da.float() - rda.float()).abs()
                      - 2 ** -7 * rda.float().abs()).max())
        da_ok = e_da <= 1e-6 * float(rda.float().abs().max())
    else:
        e_da = frac(da, rda)
        da_ok = e_da <= DROP_TOL
    ok = (same and pattern and e_out <= DROP_TOL and e_own <= DROP_TOL
          and ulp <= 0 and mism <= DROP_DX_MISMATCH and da_ok
          and abs(share - (1 - DROP_RATE)) <= 5 * sigma)
    log(f"  dropout {name}: x {tuple(x.shape)} {str(x.dtype)[6:]}, A "
        f"{str(a.dtype)[6:]}, {'forced bits' if bits is not None else 'Philox'}"
        f": out rel err {e_out:.2e}, vs own-mask forward {e_own:.2e} (tol "
        f"{DROP_TOL}); dx beyond one ulp {ulp:.2e}, not bit-identical "
        f"{mism:.2e} (tol {DROP_DX_MISMATCH}); dA err {e_da:.2e}; zeros = "
        f"plain mask {pattern}; repeat bit-identical {same}; keep share "
        f"{share:.6f} ({(share - 1 + DROP_RATE) / sigma:+.2f} sigma)")
    if not ok:
        raise AssertionError(f"fused dropout kernels disagree with their "
                             f"plain versions ({name})")
    return float((out - ref).abs().max())


def dropout_records(n, dim, inter) -> list[dict]:
    """Check kernels 6-7 at the training path's shapes (N = b·L 4096, d
    4096 and 11008, x bf16, A fp32 and bf16, Philox and forced words) and a
    ragged case, then time them over one layer's seven projections (x and A
    bf16, Philox: the path's dtypes) beside the plain versions and the
    library's ``F.dropout(x) @ A`` (forward, and its autograd backward
    alone on one recorded forward)."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import fused_dropout as fd
    err = 0.0
    cases = [(n, d, torch.bfloat16, adt, forced)
             for d in (dim, inter) for adt in (torch.float32, torch.bfloat16)
             for forced in (False, True)]
    cases.append((333, 200, torch.float32, torch.float32, False))
    for i, (rows, d, xdt, adt, forced) in enumerate(cases):
        args = dropout_case(rows, d, xdt, adt, forced, seed=i)
        err = max(err, check_dropout(f"case {i}", *args))
        del args
    dims = [dim] * 6 + [inter]  # q, k, v, o, gate, up read dim; down inter
    tot = {k: 0.0 for k in ("fwd", "bwd", "fwd_plain", "bwd_plain",
                            "fwd_lib", "bwd_lib", "fwd_bytes", "bwd_bytes",
                            "fwd_flops", "bwd_flops", "philox")}
    for d in dims:
        x, a, gout, key, _ = dropout_case(n, d, torch.bfloat16,
                                          torch.bfloat16, False, seed=50)
        tot["fwd"] += time_ms(lambda: fd.dropout_a_fwd(x, a, key, DROP_RATE))
        tot["bwd"] += time_ms(lambda: fd.dropout_a_bwd(x, a, gout, key,
                                                       DROP_RATE))
        tot["fwd_plain"] += time_ms(lambda: fd.dropout_a_fwd_plain(
            x, a, key, DROP_RATE), iters=3, warmup=1)
        tot["bwd_plain"] += time_ms(lambda: fd.dropout_a_bwd_plain(
            x, a, gout, key, DROP_RATE), iters=3, warmup=1)
        xg, ag = x.clone().requires_grad_(True), a.clone().requires_grad_(True)
        gb = gout.to(torch.bfloat16)

        def lib():
            return F.dropout(xg, DROP_RATE) @ ag

        lib_out = lib()

        def lib_bwd():  # the backward alone, on one recorded forward
            torch.autograd.grad(lib_out, (xg, ag), gb, retain_graph=True)

        tot["fwd_lib"] += time_ms(lib, iters=30, warmup=3)
        tot["bwd_lib"] += time_ms(lib_bwd, iters=30, warmup=3)
        elems = n * d
        tot["fwd_bytes"] += nbytes(x, a) + n * DROP_MR * 4
        tot["bwd_bytes"] += 2 * nbytes(x) + nbytes(a, gout) + d * DROP_MR * 4
        # the rank-M·r products of bf16 x and A (tensor cores), apart from
        # the generator's integer work (the ordinary cores), each its time
        tot["fwd_flops"] += 2 * elems * DROP_MR
        tot["bwd_flops"] += 2 * elems * 2 * DROP_MR
        tot["philox"] += elems / 4 * PHILOX_INSTR
        del x, a, gout, xg, ag, gb, lib_out
    records = []
    for which, line, kernel in (("fwd", 55, 6), ("bwd", 70, 7)):
        bms, by = bound_ms(tot[f"{which}_bytes"], tot[f"{which}_flops"],
                           BF16_FLOPS, (tot["philox"], LANE_INSTR))
        log(f"  dropout {which} (kernel {kernel}) timing, one layer's seven "
            f"projections (N {n}, d {dim} x6 + {inter}, bf16 x and A): "
            f"kernel {tot[which]:.4f} ms, plain {tot[which + '_plain']:.4f} "
            f"ms, F.dropout + matmul {tot[which + '_lib']:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        records.append({
            "name": f"dropout_a_{which}", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/fused_dropout.cu",
            "replaces": f"moka_tpu/ops/fused_dropout.py:{line}",
            "launches": None, "max_abs_err": err,
            "tolerance": f"out, dA {DROP_TOL} of max|plain|; dx one bf16 "
                         f"ulp; masks exact",
            "ms": tot[which], "plain_ms": tot[which + "_plain"],
            "bound_ms": bms, "bound_by": by,
            "library_ms": tot[which + "_lib"],
            "library": "F.dropout(x) @ A_flat in bf16" + (
                "" if which == "fwd" else ", its autograd backward alone"),
            "shape": f"N {n}, d {dim} (6 projections) and {inter} (down), "
                     f"x and A bf16, Philox: one layer, seven launches"})
    return records


def ce_case(n, d, v, seed):
    """Inputs of the fused CE kernels: x (n, d) bf16, an int8 head from
    ``quantize_int8`` of a (d, v) normal(0.02) matrix, targets with a
    quarter ignored, and a per-row cotangent (0 on the ignored rows, as the
    mean gives them)."""
    import torch
    from moka_tpu_torch.ops.quant import quantize_int8
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=g, device="cuda").bfloat16()
    head = quantize_int8(torch.randn((d, v), generator=g, device="cuda")
                         * 0.02)
    t = torch.randint(0, v, (n,), generator=g, device="cuda")
    ignored = torch.rand((n,), generator=g, device="cuda") < 0.25
    t = torch.where(ignored, -100, t)
    cot = torch.rand((n,), generator=g, device="cuda") / max(
        1, int((~ignored).sum())) * (~ignored)
    return x, head["w_i8"], head["scale"].reshape(-1), t, cot


def onehot_part(w, scale, t, cot):
    """The one-hot term of kernel 9's dx, -(g * scale[t]) * w[:, t]^T, in
    fp32 (zero on ignored rows): subtracted from the plain dx it leaves
    the softmax term, which a wrong p changes."""
    import torch
    valid = t >= 0
    tt = torch.where(valid, t, 0).long()
    coef = torch.where(valid, -cot * scale[tt], 0.0)
    return coef[:, None] * w[:, tt].t().float()


@contextlib.contextmanager
def wrong_softmax():
    """Within: kernel 9 computes p from an lse that is log 2 too small on
    every fourth row (p doubled there), a fault the CE checks must catch
    and that the forward's nll would not show."""
    import torch
    from moka_tpu_torch.ops import fused_ce as fc
    launch = fc._launch_bwd

    def shifted(x, w_q, w_scale, targets, lse, g):
        rows = torch.arange(lse.numel(), device=lse.device) % 4 == 0
        return launch(x, w_q, w_scale, targets, lse - math.log(2) * rows, g)

    fc._launch_bwd = shifted
    try:
        yield
    finally:
        fc._launch_bwd = launch


def dx_errors(dx, rdx, soft) -> dict:
    """Kernel 9's dx against the plain one: max|err| over max|plain|,
    relative L2, and the L2 error over the norm of the plain softmax term
    ``soft`` (the one-hot term dominates dx at the main shape)."""
    d = dx.float() - rdx.float()
    return {"max_frac": float(d.abs().max() / rdx.float().abs().max()),
            "rel_l2": float(d.norm() / rdx.float().norm()),
            "softmax_rel_l2": float(d.norm() / soft.norm()),
            "max_abs": float(d.abs().max())}


def dx_ok(e) -> bool:
    return (e["max_frac"] <= CE_DX_TOL[0] and e["rel_l2"] <= CE_DX_TOL[1]
            and e["softmax_rel_l2"] <= CE_SOFTMAX_TOL)


def check_ce(name, x, w, scale, t, cot, fault=False) -> tuple[float, float]:
    """Kernels 8 and 9 against ``fused_ce_fwd_plain`` /
    ``fused_ce_bwd_plain`` on the same inputs: nll and lse within
    CE_LSE_TOL; dx, both backward versions fed the plain lse, within
    CE_DX_TOL and CE_SOFTMAX_TOL and exactly zero on rows whose cotangent
    is 0.  ``fault``: kernel 9 also runs under ``wrong_softmax``, which
    the dx check must fail."""
    import torch
    from moka_tpu_torch.ops import fused_ce as fc
    nll, lse = fc.fused_ce_fwd(x, w, scale, t)
    rnll, rlse = fc.fused_ce_fwd_plain(x, w, scale, t)
    dx = fc.fused_ce_bwd(x, w, scale, t, rlse, cot)
    rdx = fc.fused_ce_bwd_plain(x, w, scale, t, rlse, cot)
    soft = rdx.float() - onehot_part(w, scale, t, cot)
    e_nll = float((nll - rnll).abs().max())
    e_lse = float((lse - rlse).abs().max())
    e = dx_errors(dx, rdx, soft)
    zeros = bool((dx[cot == 0] == 0).all())
    ok = (e_nll <= CE_LSE_TOL and e_lse <= CE_LSE_TOL and zeros and dx_ok(e)
          and bool(torch.isfinite(dx.float()).all()))
    log(f"  fused CE {name}: x {tuple(x.shape)}, head {tuple(w.shape)}: "
        f"max|nll err| {e_nll:.3e}, max|lse err| {e_lse:.3e} (tol "
        f"{CE_LSE_TOL}); dx max|err| {e['max_abs']:.3e} "
        f"({e['max_frac']:.2e} of max|plain|), rel L2 {e['rel_l2']:.2e}, "
        f"{e['softmax_rel_l2']:.2e} of the softmax term (softmax term "
        f"{float(soft.norm() / rdx.float().norm()):.2e} of dx; tol "
        f"{CE_DX_TOL[0]}, {CE_DX_TOL[1]}, {CE_SOFTMAX_TOL}); zero-cotangent "
        f"rows zero {zeros}")
    if not ok:
        raise AssertionError(f"fused CE kernels disagree with their plain "
                             f"versions ({name})")
    if fault:
        with wrong_softmax():
            bad = dx_errors(fc.fused_ce_bwd(x, w, scale, t, rlse, cot), rdx,
                            soft)
        log(f"  kernel 9 under wrong_softmax (p x 2 on every fourth row): "
            f"{bad['max_frac']:.2e} of max|plain|, rel L2 "
            f"{bad['rel_l2']:.2e}, {bad['softmax_rel_l2']:.2e} of the "
            f"softmax term (must fail)")
        if dx_ok(bad):
            raise AssertionError("the dx check passes a wrong softmax")
    return max(e_nll, e_lse), e["max_abs"]


def ce_records(n, d, v) -> list[dict]:
    """Check kernels 8-9 at the main path's shape (route B: N = 4 x 1023
    rows, d 4096, V 32011) and three ragged ones (rows and vocab off the
    tiles: kernel 9's 128 rows and 512 vocab columns a CTA, 256 a stage),
    then time each at the main path's shape beside its plain version and
    the library's int8 -> bf16 cast of the head, bf16 ``torch.matmul``,
    the scale and ``F.cross_entropy(reduction="none")`` (kernel 9: that
    forward's autograd backward alone); kernel 9 also alone, without the
    wrapper's zero fill of the fp32 workspace and its cast to bf16."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import fused_ce as fc
    err_f = err_b = 0.0
    for name, shape, seed in (("main path shape", (n, d, v), 0),
                              ("ragged rows and vocab", (333, 192, 1000), 1),
                              ("one row block", (50, 64, 203), 2),
                              ("ragged across kernel 9's tiles",
                               (1000, 4096, 5000), 4)):
        ef, eb = check_ce(name, *ce_case(*shape, seed), fault=seed == 0)
        err_f, err_b = max(err_f, ef), max(err_b, eb)
    x, w, scale, t, cot = ce_case(n, d, v, 3)
    nll, lse = fc.fused_ce_fwd(x, w, scale, t)
    ms = {"fwd": time_ms(lambda: fc.fused_ce_fwd(x, w, scale, t), iters=5),
          "bwd": time_ms(lambda: fc.fused_ce_bwd(x, w, scale, t, lse, cot),
                         iters=5)}
    inputs = fc._kernel_inputs(x, w, scale, t)
    ws = torch.zeros((n, d), dtype=torch.float32, device="cuda")
    passes = {"kernel_alone": time_ms(lambda: fc._bwd_into(
                  ws, *inputs[:4], lse, cot, inputs[4]), iters=5),
              "zero_dx": time_ms(lambda: torch.zeros_like(ws)),
              "cast_dx": time_ms(lambda: ws.to(x.dtype))}
    del ws, inputs
    log(f"  fused CE bwd (kernel 9): the kernel alone "
        f"{passes['kernel_alone']:.4f} ms; the wrapper's passes: zero fill "
        f"{passes['zero_dx']:.4f} ms, cast {passes['cast_dx']:.4f} ms")
    plain = {"fwd": time_ms(lambda: fc.fused_ce_fwd_plain(x, w, scale, t),
                            iters=3, warmup=1),
             "bwd": time_ms(lambda: fc.fused_ce_bwd_plain(x, w, scale, t,
                                                          lse, cot),
                            iters=3, warmup=1)}
    xg = x.clone().requires_grad_(True)

    def lib():
        logits = torch.matmul(xg, w.to(torch.bfloat16)).float() * scale
        return F.cross_entropy(logits, t.long(), reduction="none")

    lib_out = lib()

    def lib_bwd():
        torch.autograd.grad(lib_out, xg, cot, retain_graph=True)

    library = {"fwd": time_ms(lib, iters=5), "bwd": time_ms(lib_bwd, iters=5)}
    del lib_out, xg
    flops = 2.0 * n * d * v
    io = nbytes(x, w, scale, t)
    records = []
    for which, line, kernel, ops, out_bytes, err in (
            ("fwd", 41, 8, flops, 2 * n * 4, err_f),
            ("bwd", 77, 9, 2 * flops, nbytes(x) + 2 * n * 4, err_b)):
        bms, by = bound_ms(io + out_bytes, ops, BF16_FLOPS)
        log(f"  fused CE {which} (kernel {kernel}) timing at (N {n}, d {d}, "
            f"V {v}): kernel {ms[which]:.4f} ms, plain {plain[which]:.4f} "
            f"ms, library {library[which]:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        records.append({
            "name": f"fused_ce_{which}", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/" + (
                "fused_ce.cu" if which == "fwd" else "fused_ce_bwd.cu"),
            "replaces": f"moka_tpu/ops/fused_ce.py:{line}",
            "launches": None, "max_abs_err": err,
            "tolerance": (f"nll, lse {CE_LSE_TOL}" if which == "fwd" else
                          "dx max|err| <= %g max|plain|, rel L2 <= %g, "
                          "<= %g of the softmax term's norm"
                          % (*CE_DX_TOL, CE_SOFTMAX_TOL)),
            "ms": ms[which], "plain_ms": plain[which], "bound_ms": bms,
            "bound_by": by, "library_ms": library[which],
            **({"wrapper_passes_ms": passes} if which == "bwd" else {}),
            "library": "torch.matmul(x, bf16(w_i8)) * scale, "
                       "F.cross_entropy(reduction='none')" + (
                           "" if which == "fwd" else
                           ", its autograd backward alone"),
            "shape": f"N {n} d {d} V {v}, int8 head, 25% ignored targets"})
    return records


# kernel 10: the BOFT merge's three shapes (z 1, N, b 8, m) and the
# projections of one layer at each (q, k, v, o; gate, up; down)
BD_SHAPES = (((1, 512, 8, 4096), 4), ((1, 512, 8, 11008), 2),
             ((1, 1376, 8, 4096), 1))
BOFT_FACTORS = 2  # launches of kernel 10 per projection (one per factor)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


BD_EXTRA = (((1, 256, 16, 2048), "bfloat16"),
            ((1, 64, 32, 1024), "bfloat16"), ((1, 40, 24, 640), "bfloat16"),
            ((2, 24, 16, 384), "float32"), ((1, 512, 8, 4096), "float32"))
# kernel 10 beyond the merge: b 16, 32 and 24 (48-row tiles), fp32 x at b 16
# and at the merge's b 8
L2_BYTES = 50e6  # the H100's L2 cache


def check_block_diag(blocks, x) -> tuple[float, float]:
    """Kernel 10 against the plain einsum: (max|err|, tol), every element
    within one bf16 ulp of max|plain| (fp32 x: 1e-5 of it), as fp32 sums
    of b exact products run in another order; raises otherwise."""
    import torch
    from moka_tpu_torch.ops import fbd
    y = fbd.block_diag_matmul(blocks, x)
    torch.cuda.synchronize()
    ref = fbd.block_diag_matmul_plain(blocks, x).float()
    top = float(ref.abs().max())
    d = float((y.float() - ref).abs().max())
    bf16 = x.dtype == torch.bfloat16
    tol = bf16_ulp(top) if bf16 else 1e-5 * top
    log(f"  block_diag {tuple(blocks.shape[:3])} x {tuple(x.shape)} "
        f"{str(x.dtype)[6:]}: max|err| {d:.3e}, max|plain| {top:.3e} (tol "
        f"{tol:.3e}: {'one bf16 ulp' if bf16 else '1e-5'} of max|plain|)")
    if not d <= tol:
        raise AssertionError(f"kernel 10 disagrees with its plain version "
                             f"at x {tuple(x.shape)}")
    return d, tol


def block_diag_records() -> list[dict]:
    """Kernel 10 against the plain einsum on bf16 W and orthogonal fp32
    blocks (Cayley of N(0, 0.1^2)) at the merge's three shapes and at
    BD_EXTRA (b 16, 24, 32; fp32 x), within ``check_block_diag``'s limits;
    launched as the mutant that reads each block transposed it must fail.
    Each merge shape timed: cold (a CUDA graph of launches over x buffers
    that together exceed 3x the L2 cache: the bound's case, each input
    read from HBM), warm (a graph on one x, and the wrapper back to back
    on one x), the wrapper's host µs a call, the plain version, ``torch.bmm``
    with the casts (cold and warm) and the bytes bound.  The record sums
    one layer's merge, two factors of seven projections, cold."""
    import torch
    from moka_tpu_torch.ops import fbd
    from profile_port import graph_ms, host_us
    g = torch.Generator(device="cuda").manual_seed(21)

    def case(z, N, b, m, dtype):
        blocks = fbd.cayley(torch.randn((z, N, b, b), generator=g,
                                        device="cuda") * 0.1)
        x = (torch.randn((z, N * b, m), generator=g, device="cuda")
             * 0.02).to(dtype)
        return blocks, x

    err, ms, plain_ms, lib_ms, bms, by_shape = 0.0, 0.0, 0.0, 0.0, 0.0, {}
    n_bytes = n_ops = 0.0
    for shape, dtype in BD_EXTRA:
        check_block_diag(*case(*shape, getattr(torch, dtype)))
    for what, lib in MUTANTS["block_diag"].items():
        blocks, x = case(*BD_SHAPES[0][0], torch.bfloat16)
        with swapped_library("block_diag", lib):
            must_fail(f"kernel 10 mutant ({what})",
                      lambda: check_block_diag(blocks, x))
    for (z, N, b, m), per_layer in BD_SHAPES:
        blocks, x = case(z, N, b, m, torch.bfloat16)
        d, _ = check_block_diag(blocks, x)
        err = max(err, d)
        xs = [x] + [x.clone() for _ in range(
            max(2, math.ceil(3 * L2_BYTES / nbytes(x))) - 1)]
        cold = graph_ms([lambda x=x: fbd.block_diag_matmul(blocks, x)
                         for x in xs], n=4 * len(xs))
        warm_graph = graph_ms(lambda: fbd.block_diag_matmul(blocks, x), n=20)
        warm = time_ms(lambda: fbd.block_diag_matmul(blocks, x))
        host = host_us(lambda: fbd.block_diag_matmul(blocks, x), n=20)
        tp = time_ms(lambda: fbd.block_diag_matmul_plain(blocks, x))
        bb = blocks.view(z * N, b, b)
        lib_cold = graph_ms([lambda x=x: torch.bmm(
            bb, x.view(z * N, b, m).float()).to(x.dtype) for x in xs],
            n=4 * len(xs))
        lib_warm = time_ms(lambda: torch.bmm(
            bb, x.view(z * N, b, m).float()).to(x.dtype))
        del xs
        torch.cuda.empty_cache()
        nb, no = nbytes(blocks) + 2 * nbytes(x), 2.0 * b * x.numel()
        one, by = bound_ms(nb, no, FP32_FLOPS)
        log(f"  block_diag timing {(z, N, b, m)} bf16: kernel cold "
            f"{cold:.4f} ms ({nb / cold / 1e9:.3f} TB/s), warm graph "
            f"{warm_graph:.4f} ms, warm loop {warm:.4f} ms, host "
            f"{host:.1f} us a call; plain {tp:.4f} ms; bmm cold "
            f"{lib_cold:.4f} ms, warm {lib_warm:.4f} ms; bound {one:.4f} ms "
            f"({by})")
        k = per_layer * BOFT_FACTORS
        ms, plain_ms, lib_ms, bms = ms + k * cold, plain_ms + k * tp, \
            lib_ms + k * lib_cold, bms + k * one
        n_bytes, n_ops = n_bytes + k * nb, n_ops + k * no
        by_shape[f"{z}x{N}x{b}x{m}"] = {
            "ms": cold, "warm_graph_ms": warm_graph, "warm_ms": warm,
            "host_us": host, "plain_ms": tp, "library_ms": lib_cold,
            "library_warm_ms": lib_warm, "bound_ms": one}
    _, by = bound_ms(n_bytes, n_ops, FP32_FLOPS)
    return [{"name": "block_diag", "route": "cuda",
             "source": "moka_tpu_torch/kernels/csrc/block_diag.cu",
             "replaces": "moka_tpu/ops/fbd.py:37",
             "launches": None, "max_abs_err": err,
             "tolerance": "one bf16 ulp of max|plain|", "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": lib_ms,
             "library": "torch.bmm(blocks, x.view(N, b, m).float()) cast "
                        "to bf16",
             "by_shape": by_shape,
             "shape": "one layer's BOFT merge (b 8, 2 factors): 8 launches "
                      "at N 512 m 4096, 4 at N 512 m 11008, 2 at N 1376 "
                      "m 4096, bf16 W; ms, library_ms cold (x from HBM)"}]


RANK_TOL = 1e-5  # rank flash out and lse: max|err| as a fraction of
                 # max|plain|, fp32 sums in another order (online softmax)
RANK_BWD_TOL = 1e-4  # dq, dk, dv: the same, over one more reduction
RANK_MATH_TOL = 1e-4  # the step in fp32 with the rank kernels against the
                   # plain rank attention, per projection, relative L2 (and
                   # the loss): only the rank attention's fp32 sums run in
                   # another order (online softmax, base 2)
SFU_OPS = 4.18e12  # exp2 a second: 16 a clock on each of 132 SMs at
                   # 1.98 GHz (the SFU rate of compute capability 9.0)


def rank_case(b, L, hd=4, dead=False, seed=0, spans=None):
    """Rank-space attention inputs as MokA's training batch makes them:
    q, k, v (b, L, 1, hd) fp32 of O(1), the question span 2:L//8 as the
    key mask (or, with ``spans``, sample i's mask is 1 on each (start,
    stop) of ``spans[i]``, none where that is empty); with ``dead``, the
    last sample has no question and random keys (the kernels must still
    give the plain mean of V)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((b, L, 1, hd), generator=g, device="cuda")
                     for _ in range(4))
    mask = torch.zeros((b, L), dtype=torch.int32, device="cuda")
    if spans is None:
        mask[:, 2: max(3, L // 8)] = 1
    else:
        for i, row in enumerate(spans):
            for start, stop in row:
                mask[i, start:stop] = 1
    if dead:
        mask[-1] = 0
    return q, k, v, mask, dout


# the forward's key layouts, a sample each at L 1024: the span in the last
# 256-key tile, across a 256-key boundary, two disjoint spans, none
RANK_LAYOUTS = (((1000, 1020),), ((240, 300),), ((10, 40), (700, 760)), ())
# causal at q_offset 100: sample 0's rows 0-199 and sample 1's rows 0-399
# come before the first visible key; the others see part of the spans
RANK_CAUSAL = (((300, 420),), ((500, 520), (900, 950)))
RANK_CAUSAL_OFFSET = 100


def rank_check_cases() -> list[tuple]:
    """(name, inputs, q_offset, causal) of every case phase 3 holds the
    rank kernels to."""
    return [
        ("training shape", rank_case(4, 1024, dead=True), 0, False),
        ("key layouts", rank_case(4, 1024, seed=3, spans=RANK_LAYOUTS), 0,
         False),
        ("key layouts hd 16", rank_case(4, 1024, hd=16, seed=4,
                                        spans=RANK_LAYOUTS), 0, False),
        ("causal, rows before the first visible key",
         rank_case(2, 1024, seed=5, spans=RANK_CAUSAL), RANK_CAUSAL_OFFSET,
         True),
        ("ragged L", rank_case(3, 333, dead=True, seed=1), 0, False)]


def check_rank(name, q, k, v, mask, dout, q_offset=0, causal=False) -> dict:
    """The three rank kernels against the plain versions on one case, the
    backward on the forward kernel's lse: out and lse within RANK_TOL,
    dq/dk/dv within RANK_BWD_TOL of max|plain| (a row that sees no key:
    out the mean of V, lse ~-6.9e29 to 1e-6 of itself)."""
    import torch
    from moka_tpu_torch.ops import flash_attention as fa
    out, lse = fa.flash_rank_fwd(q, k, v, mask, q_offset, causal)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    dq = fa.flash_rank_bwd_dq(q, k, v, mask, dout, lse, delta, q_offset,
                              causal)
    dk, dv = fa.flash_rank_bwd_dkv(q, k, v, mask, dout, lse, delta, q_offset,
                                   causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mask, q_offset, causal)
    grads = fa.flash_bwd_plain(q, k, v, mask, dout, lse, delta, q_offset,
                               causal)
    L, S = q.shape[1], k.shape[1]
    live = _visible(mask, L, S, q_offset, causal).any(dim=-1)  # (b, L)
    got2, want2 = lse[:, 0], ref_lse[:, 0]
    errs = {"out": float((out - ref).abs().max() / ref.abs().max()),
            "lse": float((got2[live] - want2[live]).abs().max()
                         / want2[live].abs().max())}
    for n, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        errs[n] = float((got - want).abs().max() / want.abs().max())
    dead_ok = bool(torch.allclose(got2[~live], want2[~live], rtol=1e-6,
                                  atol=0))
    ok = dead_ok and all(errs[n] <= RANK_TOL for n in ("out", "lse")) and \
        all(errs[n] <= RANK_BWD_TOL for n in ("dq", "dk", "dv"))
    log(f"  rank flash {name}: q {tuple(q.shape)}, q_offset {q_offset}, "
        f"causal {causal}, rows that see no key {int((~live).sum())}: "
        f"max|err| / max|plain| " +
        ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) +
        f"; their lse ok {dead_ok} (tol {RANK_TOL} fwd, {RANK_BWD_TOL} bwd)")
    if not ok:
        raise AssertionError(f"rank flash kernels disagree with their "
                             f"plain versions ({name})")
    return {n: e * float(t.abs().max()) for (n, e), t in
            zip(errs.items(), (ref, want2[live], *grads))}


def rank_flash_records(b, L) -> list[dict]:
    """The rank route's three kernels (TPU kernels 1-4 at head_dim 4,
    fp32) checked on ``rank_check_cases`` (the forward's key layouts,
    causal rows before the first visible key, a ragged L, no-question
    samples); the forward launched as each RANK_MUTANTS fault must fail
    there.  Then each kernel timed at (b, L) with every sample's question
    span: the wrapper back to back (``ms``), the kernel alone (a CUDA
    graph of launches, ``device_ms``), the wrapper's host µs a call, the
    plain version, ``scaled_dot_product_attention`` (fp32, boolean key
    mask; the backward rows forward + backward less forward) and the
    bound."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import flash_attention as fa
    from profile_port import graph_ms, host_us
    cases = rank_check_cases()
    errs = [check_rank(name, *ins, q_offset, causal)
            for name, ins, q_offset, causal in cases]
    for what, lib in MUTANTS["flash_rank"].items():
        with swapped_library("flash_rank", lib):
            must_fail(f"rank forward mutant ({what})",
                      lambda: [check_rank(name, *ins, q_offset, causal)
                               for name, ins, q_offset, causal in cases])
    del cases
    q, k, v, mask, dout = rank_case(b, L, seed=2)
    out, lse = fa.flash_rank_fwd(q, k, v, mask, 0, False)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, mask, dout, lse, delta, 0, False)
    hd = q.shape[-1]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)
    bool_mask = (mask > 0)[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bool_mask)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dt)

    lib_fwd = time_ms(sdpa, iters=50)
    lib_bwd = time_ms(sdpa_fwd_bwd, iters=50) - lib_fwd
    seen = int(mask.sum())  # key rows some query sees
    pairs = float(L * seen)  # (query, key) pairs the softmax needs
    row = 4 * hd  # bytes of one fp32 row
    rows = b * L * 4  # bytes of one (b, 1, L) fp32 vector
    kv_in = seen * 2 * row + nbytes(mask)
    records = []
    for which, fn, plain, flops, n_bytes, tpu_line, lib in (
            ("fwd", lambda: fa.flash_rank_fwd(q, k, v, mask, 0, False),
             lambda: fa.flash_fwd_plain(q, k, v, mask, 0, False), 4 * hd,
             2 * nbytes(q) + kv_in + rows, 56, lib_fwd),
            ("bwd_dq", lambda: fa.flash_rank_bwd_dq(*args),
             lambda: fa.flash_bwd_dq_plain(*args), 6 * hd,
             3 * nbytes(q) + kv_in + 2 * rows, 136, lib_bwd),
            ("bwd_dkv", lambda: fa.flash_rank_bwd_dkv(*args),
             lambda: fa.flash_bwd_dkv_plain(*args), 8 * hd,
             2 * nbytes(q) + kv_in + 2 * rows + 2 * nbytes(k), 180,
             lib_bwd)):
        ms = time_ms(fn, iters=50)
        device = graph_ms(fn)
        host = host_us(fn)
        plain_ms = time_ms(plain, iters=10)
        bms, by = bound_ms(n_bytes, flops * pairs, FP32_FLOPS,
                           (pairs, SFU_OPS))
        log(f"  rank flash {which} timing at (b {b}, L {L}, hd {hd}, "
            f"{seen // b} question keys a sample): wrapper back to back "
            f"{ms:.4f} ms, kernel alone (graph) {device:.4f} ms, host "
            f"{host:.1f} us a call; plain {plain_ms:.4f} ms, sdpa "
            f"{'backward ' if which != 'fwd' else ''}{lib:.4f} ms, bound "
            f"{bms:.5f} ms ({by})")
        err = max(e[n] for e in errs for n in
                  (("out", "lse") if which == "fwd" else
                   ("dq",) if which == "bwd_dq" else ("dk", "dv")))
        records.append({
            "name": f"flash_rank_{which}", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/flash_rank.cu",
            "replaces": f"moka_tpu/ops/flash_attention.py:{tpu_line}" +
                        (" (and :230, the fused backward)"
                         if which != "fwd" else ""),
            "launches": None, "max_abs_err": err,
            "tolerance": f"{RANK_TOL if which == 'fwd' else RANK_BWD_TOL} "
                         f"of max|plain|",
            "ms": ms, "device_ms": device, "host_us": host,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library": "scaled_dot_product_attention fp32, boolean key mask"
                       + ("" if which == "fwd" else
                          ": forward + backward less forward (all three "
                          "gradients)"),
            "shape": f"b {b} L {L} S {L} H 1 hd {hd} fp32, question keys "
                     f"2:{L // 8}, one call; ms the wrapper back to back, "
                     f"device_ms a CUDA graph of launches"})
    return records


# ------------------------------------------------------------------ phase 4

def build_model(cfg, spec, seed=0):
    """bf16 LLaMA base and fp32 MokA adapters on the card, random from
    ``seed``; B is seeded non-zero (it starts at zero, a no-op)."""
    import torch
    from moka_tpu_torch.models import llama
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = llama.init_llama_params(g, cfg, device="cuda",
                                   dtype=torch.bfloat16)
    adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
    for p in adapters["layers"].values():
        p["b"].normal_(0.0, 0.02, generator=g)
    return base, adapters


def main_path_inputs(cfg, base, batch, prompt_len) -> dict:
    """bench_decode's prompts: seeded embeddings, no padding, AVT masks."""
    import torch
    from moka_tpu_torch.models import llama
    rng = np.random.default_rng(0)
    embeds = torch.as_tensor(
        rng.standard_normal((batch, prompt_len, cfg.dim)),
        dtype=torch.float32).to(device="cuda", dtype=base["embed"].dtype)
    pmask = torch.ones((batch, prompt_len), dtype=torch.int32, device="cuda")
    return {"inputs_embeds": embeds, "prompt_mask": pmask,
            "masks": llama.MaskBundle(*avt_masks(batch, prompt_len, 3))}


def generate(cfg, spec, base, adapters, inputs, new_tokens):
    """The main path: ``greedy_generate`` with its defaults for CUDA tensors
    (prefill through both kernels) and no end token."""
    from moka_tpu_torch.eval.decode import greedy_generate
    return greedy_generate(base, adapters, cfg=cfg, spec=spec,
                           max_new_tokens=new_tokens, eos_id=-1, **inputs)


def check_logits(cfg, spec, base, adapters, inputs, new_tokens,
                 plain_base=None) -> None:
    """Logits of the whole batch's prefill, run by ``decode.prefill`` as
    ``greedy_generate`` runs it (same cache size and cache mask): with both
    kernels, on the plain bf16 path, and on the plain path in fp32 on the
    same (bf16-valued) weights, or on ``plain_base``'s where it is given
    (weights the plain versions made).  Fails unless the kernel path is
    within LOGIT_RATIO times the plain bf16 path's distance from fp32, on
    the prompts' valid positions (a left-padded position sees no key: its
    attention output is unspecified, and no caller reads it)."""
    import torch
    from moka_tpu_torch.eval.decode import prefill
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused

    def logits(params, kernels, dtype):
        h, _, _ = prefill(
            params, adapters, cfg=cfg, spec=spec,
            **dict(inputs, inputs_embeds=inputs["inputs_embeds"].to(dtype)),
            max_new_tokens=new_tokens, use_flash=kernels,
            use_fused_moka=kernels)
        return llama.head_logits(h, params["lm_head"])

    with torch.inference_mode():
        flash_fwd.launches = moka_delta_fused.launches = 0
        got = logits(base, True, torch.bfloat16)
        counts = (flash_fwd.launches, moka_delta_fused.launches)
        ref = base if plain_base is None else plain_base
        plain = logits(ref, False, torch.bfloat16)
        base32 = float32(ref)  # a quantized base keeps its codes
        exact = logits(base32, False, torch.float32)
        del base32
    log(f"  kernel prefill: flash launches {counts[0]}, fused MokA "
        f"launches {counts[1]}")
    if counts != (cfg.n_layers, 7 * cfg.n_layers):
        raise AssertionError(f"prefill launches {counts}")
    valid = inputs["prompt_mask"] > 0
    got, plain, exact = got[valid], plain[valid], exact[valid]
    std = float(exact.std())

    def rel_err(x):
        d = (x - exact).abs()
        return float(d.mean()) / std, float(d.max()) / std

    (k_mean, k_max), (p_mean, p_max) = rel_err(got), rel_err(plain)
    finite = bool(torch.isfinite(got).all())
    ok = finite and k_mean <= LOGIT_RATIO * p_mean + 1e-3 and \
        k_max <= LOGIT_RATIO * p_max + 1e-2
    log(f"  prefill logits {tuple(got.shape)} vs fp32 (logit std {std:.3f}):"
        f" kernel path mean|d|/std {k_mean:.3e} max {k_max:.3e}; plain bf16 "
        f"path mean {p_mean:.3e} max {p_max:.3e}; kernels vs plain mean "
        f"{float((got - plain).abs().mean()) / std:.3e}; finite {finite} "
        f"(tol: kernel <= {LOGIT_RATIO} x plain)")
    if not ok:
        raise AssertionError("prefill logits: the kernel path is further "
                             "from fp32 than the plain bf16 path")


def main_path(gen, batch: int, new_tokens: int, vocab: int, want: dict,
              what: str) -> dict:
    """Times ``gen(1)`` (the prefill and the head on its last row, no
    decode step; median of three) and ``gen(new_tokens)`` (the main path:
    launch counts zeroed just before, read just after, and required to
    equal ``want``).  Decode = the difference; its cache is new_tokens - 1
    positions longer."""
    import torch

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen(n)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    with torch.inference_mode():
        gen(new_tokens)  # warm-up
        prefill_s = sorted(timed(1)[1] for _ in range(3))[1]
        _zero_counts()
        toks, total_s = timed(new_tokens)
        launches = _counts()
    if tuple(toks.shape) != (batch, new_tokens) or \
            int(toks.min()) < 0 or int(toks.max()) >= vocab:
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    tps = batch * (new_tokens - 1) / (total_s - prefill_s)
    log(f"  {what} new {new_tokens}: total {total_s * 1e3:.1f} ms, "
        f"1 new token {prefill_s * 1e3:.1f} ms, decode "
        f"{(total_s - prefill_s) * 1e3:.1f} ms, {tps:.1f} tok/s "
        f"({new_tokens - 1} decode steps), launches {launches}")
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "decode_ms": (total_s - prefill_s) * 1e3, "decode_tok_s": tps,
            "total_ms": total_s * 1e3}


# ------------------------------------------------------------------ phase 5

def serve_requests(cfg, spec, base, adapters, n_slots=8,
                   capacity=2048, new_tokens=32,
                   prompt_lens=(100, 300, 700), stream_len=200,
                   bucket=128) -> dict:
    import torch
    from moka_tpu_torch.eval.engine import DecodeEngine
    from moka_tpu_torch.eval.server import serve_continuous
    from moka_tpu_torch.models import llama

    engine = DecodeEngine(base, adapters, cfg=cfg, spec=spec,
                          n_slots=n_slots, cache_capacity=capacity,
                          eos_id=-1, steps_per_dispatch=8,
                          cache_dtype=base["embed"].dtype)

    def prep(item):
        ids = np.asarray(json.loads(item["prompt"]), np.int64)
        n = len(ids)
        lp = -(-n // bucket) * bucket
        padded = np.zeros(lp, np.int64)
        padded[:n] = ids
        embeds = base["embed"][torch.as_tensor(padded, device="cuda")][None]
        pmask = np.zeros((1, lp), np.float32)
        pmask[0, :n] = 1
        mod, qm = avt_masks(1, lp, spec.num_modalities, n_valid=n)
        return embeds, pmask, llama.MaskBundle(mod, qm)

    def decode_txt(toks):
        return " ".join(str(int(t)) for t in toks)

    server = serve_continuous(engine, prep, decode_txt, host="127.0.0.1",
                              port=0, max_new_tokens=new_tokens)
    port = server.server_address[1]
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    rng = np.random.default_rng(1)
    results: dict = {}

    def post(path, n):
        ids = rng.integers(3, cfg.vocab_size, n).tolist()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps({"prompt": json.dumps(ids)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = resp.read()
        if path == "/generate":
            results[(path, n)] = len(json.loads(body)["output"].split())
        else:
            lines = [json.loads(x) for x in body.splitlines()]
            results[(path, n)] = sum("token" in x for x in lines)

    jobs = [("/generate", n) for n in prompt_lens] + \
        [("/generate_stream", stream_len)]
    _zero_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=j) for j in jobs]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        server_thread.join(timeout=10)
    wall = time.perf_counter() - t0
    launches = _counts()
    log(f"  served {len(jobs)} requests in {wall:.2f} s: tokens "
        f"{ {f'{p} {n}': c for (p, n), c in results.items()} }, launches "
        f"{launches}")
    if any(t.is_alive() for t in threads) or len(results) != len(jobs) or \
            any(c != new_tokens for c in results.values()):
        raise AssertionError(f"serving: wrong token counts {results}")
    return {"wall_s": wall, "launches": launches}


# ------------------------------------------------------------- phases 6-7

PROJS = ("q", "k", "v", "o", "gate", "up", "down")


def train_config(long_context=False):
    """bench.py's 7B row with a bf16 base: vocab 32011, MokA AVT r=4 with
    dropout 0.05 and a 256-key question window; the long-context row adds
    dynamic-NTK RoPE (bench.py:680-683)."""
    import dataclasses
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.ops.moka import MokaSpec
    cfg = LlamaConfig.llama2_7b(vocab_size=32011)
    if long_context:
        cfg = dataclasses.replace(cfg, rope_scaling=("dynamic", 2.0))
    spec = MokaSpec.avt(rank=4, dropout_rate=0.05).with_question_window(256)
    return cfg, spec


def build_trainer(cfg, spec, seed=1):
    """bf16 base and fp32 adapters (B seeded non-zero) on the card."""
    base, adapters = build_model(cfg, spec, seed)
    return base, {"adapters": adapters}


def train_batch(cfg, b, L, seed=0) -> dict:
    """bench.py:91-104: random tokens, a quarter of the labels ignored,
    text / video / audio = 1/2, 1/4, 1/4, question span 2:L//8."""
    import torch
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab_size, (b, L))
    labels = np.where(rng.random((b, L)) < 0.25, -100, toks)
    mod = np.zeros((3, b, L), np.float32)
    mod[0, :, : L // 2] = 1
    mod[1, :, L // 2: 3 * L // 4] = 1
    mod[2, :, 3 * L // 4:] = 1
    q = np.zeros((b, L), np.float32)
    q[:, 2: L // 8] = 1
    return {k: torch.as_tensor(v, device="cuda") for k, v in
            dict(tokens=toks, labels=labels, modality_masks=mod,
                 question_mask=q).items()}


def train_loss(cfg, spec, use_flash, policy=None, **quant):
    """The fine-tune loss as bench.py::run builds it (remat under
    ``policy``, full by default; chunked lm_head + CE of 128 positions);
    ``quant``: the quantized recipe's options (``QUANT_RECIPE``)."""
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    return make_llama_moka_loss(cfg, spec, remat=True, use_flash=use_flash,
                                fused_loss=True, ce_chunk=128,
                                remat_policy=policy, **quant)


def loss_and_grads(cfg, spec, frozen, trainable, batch, use_flash, key,
                   policy=None, **quant):
    """(loss, {projection: its adapter gradients of every layer, flat},
    {projection: those of the last layer, flat})."""
    import torch
    from moka_tpu_torch.train.optim import tree_leaves
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = train_loss(cfg, spec, use_flash, policy, **quant)(
        trainable, frozen, batch, key)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    flat, last = {}, {}
    for (name, _), g in zip(sorted((n, ab) for n in PROJS for ab in "ab"),
                            grads):
        flat.setdefault(name, []).append(g.flatten())
        last.setdefault(name, []).append(g[-1].flatten())
    return (float(loss.detach()), {n: torch.cat(v) for n, v in flat.items()},
            {n: torch.cat(v) for n, v in last.items()})


def first_layers(tree, n):
    """A layer-stacked parameter tree cut to its first ``n`` layers
    (views)."""
    out = dict(tree)
    out["layers"] = {k: ({kk: t[:n] for kk, t in v.items()}
                         if isinstance(v, dict) else v[:n])
                     for k, v in tree["layers"].items()}
    return out


def check_train_grads(cfg, spec, frozen, trainable, batch) -> dict:
    """Loss and adapter gradients of one step through the kernels, through
    the plain attention (eager ``mha``, bf16 base) and in fp32 (eager, the
    same base values in fp32), same dropout key; fails unless the kernel
    path is within TRAIN_RATIO of the plain path's distance from fp32, per
    projection (relative L2 over every layer's A and B gradients).  Run at
    full depth and at SHALLOW layers: through 32 layers of random bf16
    weights both paths drift ~16% from fp32, enough to hide a kernel that
    drops the causal diagonal; at 2 layers the same rule catches it."""
    import dataclasses
    out = {}
    for n in (cfg.n_layers, SHALLOW):
        log(f"  {n} layers:")
        out[f"{n}_layers"] = _check_train_grads(
            dataclasses.replace(cfg, n_layers=n), spec,
            first_layers(frozen, n), {"adapters": first_layers(
                trainable["adapters"], n)}, batch)
    return out


@contextlib.contextmanager
def plain_versions():
    """Within: ``moka_delta``'s fused dropout runs its plain versions
    (``dropout_a_proj_plain``, same Philox words) instead of kernels 6-7,
    ``pallas_ce`` its plain CE (``fused_ce_loss_plain``) instead of
    kernels 8-9, and the flash rank attention the plain flash forward and
    backward instead of the rank kernels."""
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops import flash_attention as fa
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops import fused_dropout as fd
    kernels = (fd.dropout_a_proj, llama.fused_ce_loss, fa.flash_rank_fwd,
               fa.flash_rank_bwd_dq, fa.flash_rank_bwd_dkv)
    fd.dropout_a_proj = fd.dropout_a_proj_plain
    llama.fused_ce_loss = fc.fused_ce_loss_plain
    fa.flash_rank_fwd = fa.flash_fwd_plain
    fa.flash_rank_bwd_dq = fa.flash_bwd_dq_plain
    fa.flash_rank_bwd_dkv = fa.flash_bwd_dkv_plain
    try:
        yield
    finally:
        (fd.dropout_a_proj, llama.fused_ce_loss, fa.flash_rank_fwd,
         fa.flash_rank_bwd_dq, fa.flash_rank_bwd_dkv) = kernels


def float32(tree):
    """A parameter tree with its floating leaves in fp32 (a quantized
    base keeps its integer codes)."""
    if isinstance(tree, dict):
        return {k: float32(v) for k, v in tree.items()}
    if tree is None:  # BEATs' absent patch bias
        return None
    return tree.float() if tree.is_floating_point() else tree


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _check_train_grads(cfg, spec, frozen, trainable, batch, policy=None,
                       key_seed=11, **quant) -> dict:
    """The kernel path (flash kernels and, with fused dropout, kernels 6-7,
    with ``pallas_ce`` kernels 8-9) against the plain path (eager
    attention, plain dropout and CE, the same masks) and an fp32 run (the
    same base values in fp32, quantized codes kept), under remat
    ``policy``."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    key = DropoutKey(key_seed)
    kern = loss_and_grads(cfg, spec, frozen, trainable, batch, True, key,
                          policy, **quant)
    frozen32 = float32(frozen)
    with plain_versions():
        plain = loss_and_grads(cfg, spec, frozen, trainable, batch, False,
                               key, policy, **quant)
        exact = loss_and_grads(cfg, spec, frozen32, trainable, batch, False,
                               key, policy, **quant)
    del frozen32
    torch.cuda.empty_cache()

    out = {"loss": {"kernels": kern[0], "plain": plain[0], "fp32": exact[0]},
           "grad_rel_l2": {}}
    ok = all(math.isfinite(x) for x in out["loss"].values())
    dk, dp = abs(kern[0] - exact[0]), abs(plain[0] - exact[0])
    ok &= dk <= TRAIN_RATIO * dp + TRAIN_FLOOR * abs(exact[0])
    log(f"  loss: kernels {kern[0]:.6f}, plain {plain[0]:.6f}, fp32 "
        f"{exact[0]:.6f} (|kernels - fp32| {dk:.3e} vs plain {dp:.3e})")
    for n in PROJS:
        ek, ep = rel(kern[1][n], exact[1][n]), rel(plain[1][n], exact[1][n])
        ekp = rel(kern[1][n], plain[1][n])
        finite = bool(torch.isfinite(kern[1][n]).all())
        good = finite and ek <= TRAIN_RATIO * ep + TRAIN_FLOOR
        ok &= good
        out["grad_rel_l2"][n] = {"kernels_vs_fp32": ek, "plain_vs_fp32": ep,
                                 "kernels_vs_plain": ekp}
        log(f"  grad {n}: rel L2 vs fp32 kernels {ek:.3e}, plain {ep:.3e}; "
            f"kernels vs plain {ekp:.3e}; norm {float(exact[1][n].norm()):.3e}"
            f"{'' if good else '  <-- FAIL'}")
    log(f"  (tol: kernels <= {TRAIN_RATIO} x plain + {TRAIN_FLOOR}, per "
        f"projection and for the loss)")
    if not ok:
        raise AssertionError("training step: the kernel path is further from "
                             "fp32 than the plain bf16 path allows")
    return out


def train_steps(cfg, spec, frozen, trainable, batch, policy=None,
                busy=False, n_warm=2, n_timed=5, loss_fn=None,
                **quant) -> dict:
    """A training path: ``make_train_step`` with
    ``make_optimizer(TrainConfig(), total_steps=1000)`` and remat under
    ``policy`` (``quant``: the quantized recipe's options), or over
    ``loss_fn`` where it is given.  ``n_warm``
    warm-up steps (the first has learning rate 0; the adapters must have
    moved after the second), then ``n_timed`` timed steps with the launch
    counts zeroed just before and read just after; with ``busy``, then one
    step under ``profile_port.trace`` for the device's busy time.  The
    trainable tree is updated in place: pass a copy to keep it."""
    import torch
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train.optim import make_optimizer, tree_leaves
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    tx = make_optimizer(TrainConfig(), total_steps=1000)
    state = init_train_state(trainable, tx, DropoutKey(0))
    step = make_train_step(loss_fn or train_loss(cfg, spec, True, policy,
                                                 **quant), tx)
    start = [p.clone() for p in tree_leaves(state.params)]

    def moved():
        return any(not torch.equal(a, b)
                   for a, b in zip(start, tree_leaves(state.params)))

    losses, norms = [], []
    for i in range(n_warm):
        state, m = step(state, frozen, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0 and moved():
            raise AssertionError("step 1 moved the adapters at LR 0")
    if not moved() and n_warm > 1:
        raise AssertionError("the adapters did not change after step 2")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch)
        losses.append(float(m["loss"]))  # synchronises
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n_timed for k, v in counts.items()}
    b, L = batch["labels"].shape
    step_ms = float(np.median(times)) * 1e3
    log(f"  train steps b {b} L {L}: losses {[round(x, 5) for x in losses]}"
        f", grad_norm {[round(x, 5) for x in norms]}")
    log(f"  step {step_ms:.1f} ms median of {n_timed} "
        f"({[round(t * 1e3, 1) for t in times]}), "
        f"{b * L / (step_ms / 1e3):.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB, launches a step {per_step}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError("non-finite loss or grad norm")
    out = {"step_ms": step_ms, "step_ms_all": [t * 1e3 for t in times],
           "step_ms_min": min(times) * 1e3,
           "tokens_per_s": b * L / (step_ms / 1e3), "losses": losses,
           "grad_norms": norms, "peak_memory_bytes": peak,
           "launches_per_step": per_step}
    if busy:
        import profile_port

        def one():
            nonlocal state
            state, m = step(state, frozen, batch)
            float(m["loss"])

        traced, ops, _ = profile_port.trace(one)
        busy_ms = sum(us for _, us in ops.values()) / 1e3
        out.update(busy_ms=busy_ms, traced_ms=traced,
                   busy_share=busy_ms / step_ms,
                   device_ops=sum(c for c, _ in ops.values()),
                   device_ms_by_group=profile_port.groups(ops))
        log(f"  traced step {traced:.1f} ms: device busy {busy_ms:.1f} ms, "
            f"{100 * busy_ms / step_ms:.1f}% of the untraced median step; "
            f"{out['device_ops']} device operations; by group "
            f"{ {g: round(v, 1) for g, v in out['device_ms_by_group'].items()} }")
    return out


def policy_ladder(cfg, spec, frozen, trainable, batch,
                  policies=("full", "qkvod_lse", "proj_nokv_lse",
                            "proj_lse")) -> dict:
    """One step of the fused-dropout path under each remat policy (after
    one untimed step): step ms, peak memory, launches."""
    import torch
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train.optim import make_optimizer
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    out = {}
    for policy in policies:
        tx = make_optimizer(TrainConfig(), total_steps=1000)
        state = init_train_state(trainable, tx, DropoutKey(6))
        step = make_train_step(train_loss(
            cfg, spec, True, None if policy == "full" else policy), tx)
        state, m = step(state, frozen, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        out[policy] = {"step_ms": wall * 1e3, "loss": loss,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       "launches": {k: v for k, v in _counts().items() if v}}
        log(f"  policy {policy}: step {wall * 1e3:.1f} ms, peak memory "
            f"{out[policy]['peak_memory_bytes'] / 2**30:.2f} GiB, loss "
            f"{loss:.5f}, launches {out[policy]['launches']}")
        del state, step, tx
        torch.cuda.empty_cache()
    return out


def fused_train_config():
    """The fused-dropout path's spec: bench.py:55-70 with bf16 dots, the
    256-key question window and fused dropout."""
    cfg, spec = train_config()
    return cfg, spec.with_bf16_dots().with_fused_dropout()


def check_fused_train_grads(cfg, spec, frozen, trainable, batch) -> dict:
    """At SHALLOW layers, under ``proj_lse``: the kernel path (flash and
    kernels 6-7) against the plain path (eager attention and plain dropout
    on the same Philox masks) and an fp32 run; then ``proj_lse`` against
    full remat with the same key, which may differ only by the fused flash
    backward's varying dq summation order (measured as the spread of two
    full-remat runs)."""
    import dataclasses
    from moka_tpu_torch.core.rng import DropoutKey
    n = SHALLOW
    cfg = dataclasses.replace(cfg, n_layers=n)
    frozen = first_layers(frozen, n)
    trainable = {"adapters": first_layers(trainable["adapters"], n)}
    log(f"  {n} layers, proj_lse:")
    out = _check_train_grads(cfg, spec, frozen, trainable, batch,
                             policy="proj_lse", key_seed=12)
    key = DropoutKey(12)
    lse = loss_and_grads(cfg, spec, frozen, trainable, batch, True, key,
                         "proj_lse")
    full, again = (loss_and_grads(cfg, spec, frozen, trainable, batch, True,
                                  key) for _ in range(2))
    out["proj_lse_vs_full"] = {}
    ok = True
    for p in PROJS:
        d, noise = rel(lse[1][p], full[1][p]), rel(again[1][p], full[1][p])
        out["proj_lse_vs_full"][p] = {"rel_l2": d, "full_vs_full": noise}
        ok &= d <= REMAT_NOISE[0] * noise + REMAT_NOISE[1]
        log(f"  grad {p}: proj_lse vs full remat rel L2 {d:.3e}; full vs "
            f"full (dq order) {noise:.3e}")
    log(f"  loss proj_lse {lse[0]:.6f}, full {full[0]:.6f}, {again[0]:.6f} "
        f"(tol: proj_lse vs full <= {REMAT_NOISE[0]} x full vs full + "
        f"{REMAT_NOISE[1]})")
    if not ok:
        raise AssertionError("proj_lse gradients differ from full remat "
                             "beyond the flash backward's dq-order noise")
    return out


QUANT_RECIPE = dict(a8_dots="full", save_q8=True)  # with remat "proj_lse"


def quant_train_config():
    """The shipping text recipe ``llama2_7b_int4a8_qh_sq8_plse``
    (``bench.py:621-629``, run by ``bench.py:717-728``): phase 6's model
    and spec with bf16 dots (LoRA dropout unfused); the loss adds
    ``QUANT_RECIPE`` under ``proj_lse``."""
    cfg, spec = train_config()
    return cfg, spec.with_bf16_dots()


def build_quant_trainer(cfg, spec, seed=3):
    """The int4 base and int8 lm_head built on the card by
    ``init_llama_params_quantized`` (one projection family at a time),
    fp32 adapters with B seeded non-zero."""
    import torch
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.quant import init_llama_params_quantized
    g = torch.Generator(device="cuda").manual_seed(seed)
    frozen = init_llama_params_quantized(g, cfg, bits=4, head_bits=8,
                                         device="cuda")
    adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
    for p in adapters["layers"].values():
        p["b"].normal_(0.0, 0.02, generator=g)
    return frozen, {"adapters": adapters}


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def check_quant_train_grads(cfg, spec, frozen, trainable, batch) -> dict:
    """At SHALLOW layers, route B (flash and kernels 8-9 on the quantized
    recipe): first against the plain path (eager attention, the plain CE,
    the same quantized base and a8 products) and an fp32 run under the
    rule of phase 6 (``_check_train_grads``); then against the same step
    with only kernels 8-9 swapped for the plain CE, flash on both sides:
    the loss within CE_LSE_TOL; each projection's gradients within
    CE_GRAD_NOISE of the spread of two kernel runs (flash's dq order,
    amplified by the int8 roundings of the cotangents); and the last
    layer's down adapter, whose cotangent is the CE's dx through the final
    norm with no int8 rounding between, within CE_LAST_DOWN_TOL, which
    kernel 9 under ``wrong_softmax`` must exceed."""
    import dataclasses
    from moka_tpu_torch.core.rng import DropoutKey
    n = SHALLOW
    cfg = dataclasses.replace(cfg, n_layers=n)
    frozen = first_layers(frozen, n)
    trainable = {"adapters": first_layers(trainable["adapters"], n)}
    log(f"  {n} layers, route B (pallas_ce), proj_lse, a8_dots full, "
        f"save_q8:")
    out = _check_train_grads(cfg, spec, frozen, trainable, batch,
                             policy="proj_lse", key_seed=13, pallas_ce=True,
                             **QUANT_RECIPE)

    def run():
        return loss_and_grads(cfg, spec, frozen, trainable, batch, True,
                              DropoutKey(13), "proj_lse", pallas_ce=True,
                              **QUANT_RECIPE)

    kern, again = run(), run()
    with plain_versions():
        plain = run()
    with wrong_softmax():
        wrong = run()
    ratio, floor = CE_GRAD_NOISE
    ok = abs(kern[0] - plain[0]) <= CE_LSE_TOL
    iso = out["ce_kernels_vs_plain_ce"] = {}
    for p in PROJS:
        d, noise = rel(kern[1][p], plain[1][p]), rel(again[1][p], kern[1][p])
        good = d <= ratio * noise + floor
        ok &= good
        iso[p] = {"rel_l2": d, "kernels_vs_kernels": noise,
                  "wrong_softmax": rel(wrong[1][p], plain[1][p])}
        log(f"  grad {p}: CE kernels vs plain CE rel L2 {d:.3e}; kernels vs "
            f"kernels {noise:.3e}; wrong_softmax vs plain CE "
            f"{iso[p]['wrong_softmax']:.3e}{'' if good else '  <-- FAIL'}")
    last = {k: rel(r[2]["down"], base[2]["down"]) for k, r, base in (
        ("rel_l2", kern, plain), ("kernels_vs_kernels", again, kern),
        ("wrong_softmax", wrong, plain))}
    iso["last_down"] = last
    ok &= last["rel_l2"] <= CE_LAST_DOWN_TOL
    log(f"  last layer's down adapter: CE kernels vs plain CE rel L2 "
        f"{last['rel_l2']:.3e}, kernels vs kernels "
        f"{last['kernels_vs_kernels']:.3e}, wrong_softmax vs plain CE "
        f"{last['wrong_softmax']:.3e} (tol {CE_LAST_DOWN_TOL}; the last "
        f"must fail)")
    log(f"  loss: CE kernels {kern[0]:.6f}, plain CE {plain[0]:.6f} (tol "
        f"{CE_LSE_TOL}); gradients tol {ratio} x kernels vs kernels + "
        f"{floor}")
    if not ok:
        raise AssertionError("route B: kernels 8-9 move the step's loss or "
                             "gradients beyond their tolerance")
    if last["wrong_softmax"] <= CE_LAST_DOWN_TOL:
        raise AssertionError("route B's gradient check passes a wrong "
                             "softmax in kernel 9")
    return out


def quant_steps(cfg, spec, frozen, trainable, batch, fused_peak) -> dict:
    """Route B (``pallas_ce``: kernels 8-9) for 2 + 5 steps with a traced
    step, then route A (the chunked CE on the a8 head) for 1 + 3, each
    from the same adapters and key: launches a step asserted, losses must
    fall, and the two routes' first losses (same forward, other head
    product) agree within HEAD_ROUTES_TOL."""
    out = {}
    for route, kw, steps in (("B", dict(pallas_ce=True), (2, 5)),
                             ("A", {}, (1, 3))):
        log(f"  route {route}:")
        run = train_steps(cfg, spec, frozen, clone_tree(trainable), batch,
                          policy="proj_lse", busy=route == "B",
                          n_warm=steps[0], n_timed=steps[1], **kw,
                          **QUANT_RECIPE)
        ce = 1 if route == "B" else 0
        want = _launches(flash_fwd=cfg.n_layers,
                         flash_bwd_fused=cfg.n_layers, fused_ce_fwd=ce,
                         fused_ce_bwd=ce)
        if run["launches_per_step"] != want:
            raise AssertionError(f"quantized route {route} launches "
                                 f"{run['launches_per_step']}, want {want}")
        if not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"route {route}: the loss did not fall: "
                                 f"{run['losses']}")
        out[route] = run
    a, b = out["A"]["losses"][0], out["B"]["losses"][0]
    gap = abs(a - b) / abs(b)
    log(f"  first-step loss: route A {a:.6f}, route B {b:.6f}, relative "
        f"gap {gap:.2e} (tol {HEAD_ROUTES_TOL}); route B peak "
        f"{out['B']['peak_memory_bytes'] / 2**30:.2f} GiB against the bf16 "
        f"base's proj_lse step (phase 8) {fused_peak / 2**30:.2f} GiB")
    if not gap <= HEAD_ROUTES_TOL:
        raise AssertionError("routes A and B disagree beyond the head's "
                             "rounding")
    out["first_loss_gap"] = gap
    return out


def long_context_step(frozen, trainable) -> dict:
    """One step at b 1, L 4096 with dynamic-NTK RoPE, full depth: the
    backward runs the dq + dkv pair (the padded length exceeds 1024)."""
    import torch
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train.optim import make_optimizer
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    cfg, spec = train_config(long_context=True)
    batch = train_batch(cfg, 1, 4096, seed=2)
    tx = make_optimizer(TrainConfig(), total_steps=1000)
    step = make_train_step(train_loss(cfg, spec, True), tx)
    state = init_train_state(trainable, tx, DropoutKey(5))
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    state, m = step(state, frozen, batch)
    loss = float(m["loss"])
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"  long-context step b 1 L 4096 ({cfg.n_layers} layers, rope "
        f"{cfg.rope_scaling}): {wall * 1e3:.1f} ms (first step of a fresh "
        f"state), loss {loss:.5f}, grad_norm {float(m['grad_norm']):.5f}, "
        f"launches {counts}")
    want = _launches(flash_fwd=2 * cfg.n_layers, flash_bwd_dq=cfg.n_layers,
                     flash_bwd_dkv=cfg.n_layers)
    if counts != want or not math.isfinite(loss):
        raise AssertionError(f"long-context step: launches {counts}, loss "
                             f"{loss}")
    return {"step_ms": wall * 1e3, "loss": loss, "launches": counts}


# ----------------------------------------------------------------- phase 10

BOFT_BLOCK = 8  # the smallest block JAX's kernel path takes
NORM_TOL = 2.0 ** -8  # column norms of a merged weight against the base's,
                      # relative: R is orthogonal, so only the bf16 rounding
                      # of each merged element (2^-8 relative at most) moves
                      # them


def boft_adapters(cfg, seed=5) -> dict:
    """One ``BoftSpec(8, 2)`` adapter per projection and layer, stacked
    (n_layers, 2, d_in / 8, 8, 8) fp32, Q ~ N(0, 0.1^2) so that R != I."""
    import torch
    from moka_tpu_torch.models.llama import _proj_shapes
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {name: torch.randn((cfg.n_layers, BOFT_FACTORS, d_in // BOFT_BLOCK,
                               BOFT_BLOCK, BOFT_BLOCK), generator=g,
                              device="cuda") * 0.1
            for name, (d_in, _) in _proj_shapes(cfg).items()}


def boft_merge(cfg, base, boft, use_pallas) -> dict:
    """The base with every projection replaced by its BOFT-adapted weight
    (``boft_weight``, a layer at a time into a new stacked tensor); the
    other leaves are the base's own tensors."""
    import torch
    from moka_tpu_torch.adapters.peft import BoftSpec, boft_weight
    spec = BoftSpec(block_size=BOFT_BLOCK, n_factors=BOFT_FACTORS)
    layers = dict(base["layers"])
    with torch.no_grad():
        for name, q in boft.items():
            out = torch.empty_like(base["layers"][name])
            for i in range(cfg.n_layers):
                out[i] = boft_weight(base["layers"][name][i], {"q": q[i]},
                                     spec, use_pallas=use_pallas)
            layers[name] = out
    return dict(base, layers=layers)


def boft_merge_and_serve(cfg, spec, base, adapters, inputs,
                         new_tokens) -> dict:
    """Phase 10: merge a BOFT adapter into all 224 projections through
    kernel 10 (launch counts zeroed before, read after: 448), once more
    under ``profile_port.trace`` (kernel 10's device time, the busy
    share), and through the plain einsum; layer 0's seven weights within one bf16 ulp of
    max|plain|; every merged weight's column norms within NORM_TOL of the
    base's; then phase 4's prefill on the kernel-merged base against the
    plain path and fp32 on the plain-merged one (``check_logits``).  Drops
    ``base``'s layer tensors from the caller's dict to make room."""
    import torch
    from moka_tpu_torch.models.llama import PROJ_DIMS
    boft = boft_adapters(cfg)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    merged = boft_merge(cfg, base, boft, use_pallas=True)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    import profile_port
    traced, ops, _ = profile_port.trace(
        lambda: boft_merge(cfg, base, boft, use_pallas=True))
    by_group = profile_port.groups(ops)
    kernel_ms = by_group["block-diagonal kernel (port)"]
    busy_ms = sum(us for _, us in ops.values()) / 1e3
    log(f"  a traced kernel merge: {traced:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, kernel 10 {kernel_ms:.3f} ms, by group "
        f"{ {g: round(v, 1) for g, v in by_group.items() if v} }")
    t0 = time.perf_counter()
    plain = boft_merge(cfg, base, boft, use_pallas=False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_proj = len(PROJ_DIMS) * cfg.n_layers
    log(f"  merged {n_proj} projections: kernel path {merge_ms:.1f} ms, "
        f"plain path {plain_ms:.1f} ms; launches {counts}")
    if counts != _launches(block_diag=BOFT_FACTORS * n_proj):
        raise AssertionError(f"BOFT merge launches {counts}")
    worst = {}
    for name in PROJ_DIMS:
        got, want = merged["layers"][name][0].float(), \
            plain["layers"][name][0].float()
        d, top = float((got - want).abs().max()), float(want.abs().max())
        worst[name] = d / bf16_ulp(top)
        if not d <= bf16_ulp(top):
            raise AssertionError(f"layer 0 {name}: merged weight {d:.3e} "
                                 f"from the plain merge (one ulp "
                                 f"{bf16_ulp(top):.3e})")
    norm_err, moved = 0.0, float("inf")
    for name in PROJ_DIMS:
        for i in range(cfg.n_layers):
            w = base["layers"][name][i].float()
            m = merged["layers"][name][i].float()
            n0 = w.norm(dim=0)
            norm_err = max(norm_err, float(((m.norm(dim=0) - n0).abs()
                                            / n0).max()))
            moved = min(moved, float((m - w).abs().max() / w.abs().max()))
    log(f"  layer 0 max|kernel - plain| in bf16 ulps of max|plain|: "
        f"{ {k: round(v, 3) for k, v in worst.items()} }; column norms: max "
        f"relative change {norm_err:.3e} (tol {NORM_TOL:.3e}); smallest "
        f"max|W' - W| / max|W| {moved:.3e} (R != I)")
    if not (norm_err <= NORM_TOL and moved > 1e-2):
        raise AssertionError("BOFT merge: column norms moved, or the "
                             "weights did not")
    base["layers"] = {}  # the merged trees hold what is still needed
    del boft
    gc.collect()
    torch.cuda.empty_cache()
    check_logits(cfg, spec, merged, adapters, inputs, new_tokens,
                 plain_base=plain)
    return {"merge_ms": merge_ms, "plain_merge_ms": plain_ms,
            "traced_merge_ms": traced, "traced_busy_ms": busy_ms,
            "traced_kernel_ms": kernel_ms, "launches": counts, "layer0_ulps": worst,
            "column_norm_rel_err": norm_err, "min_rel_change": moved}


# ----------------------------------------------------------------- phase 11

def rank_train_config():
    """Phase 6's model and spec with ``with_flash_rank_attn()``
    (``bench.py``'s ``flash_rank_attn``): the question window no longer
    applies."""
    cfg, spec = train_config()
    return cfg, spec.with_flash_rank_attn()


def check_rank_train_grads(cfg, spec, frozen, trainable, batch) -> dict:
    """At SHALLOW layers: the rank kernels' loss and adapter gradients
    against the same step with the rank kernels swapped for the plain
    versions (and eager attention, ``plain_versions``) and fp32, by phase
    6's ratio rule; then, with the base in fp32 and eager decoder
    attention, against the spec without ``flash_rank_attn`` (the plain
    rank attention, the same math) by RANK_MATH_TOL: in bf16 any rounding
    flip moves these gradients by ~1e-2, which would hide a fault."""
    import dataclasses
    from moka_tpu_torch.core.rng import DropoutKey
    n = SHALLOW
    cfg = dataclasses.replace(cfg, n_layers=n)
    frozen = first_layers(frozen, n)
    trainable = {"adapters": first_layers(trainable["adapters"], n)}
    log(f"  {n} layers, full remat:")
    out = _check_train_grads(cfg, spec, frozen, trainable, batch,
                             key_seed=13)
    key = DropoutKey(13)
    frozen32 = float32(frozen)
    _zero_counts()
    rank = loss_and_grads(cfg, spec, frozen32, trainable, batch, False, key)
    counts = _counts()
    plain = loss_and_grads(cfg, dataclasses.replace(spec,
                                                    flash_rank_attn=False),
                           frozen32, trainable, batch, False, key)
    del frozen32
    calls = 2 * len(PROJS) * n
    if counts != _launches(flash_rank_fwd=2 * calls, flash_rank_bwd_dq=calls,
                           flash_rank_bwd_dkv=calls):
        raise AssertionError(f"fp32 rank step launches {counts}")
    out["fp32_rank_vs_plain_attention"] = {}
    d_loss = abs(rank[0] - plain[0]) / abs(plain[0])
    ok = d_loss <= RANK_MATH_TOL
    for p in PROJS:
        d = rel(rank[1][p], plain[1][p])
        out["fp32_rank_vs_plain_attention"][p] = d
        ok &= d <= RANK_MATH_TOL
        log(f"  fp32 grad {p}: rank kernels vs plain rank attention rel L2 "
            f"{d:.3e}")
    log(f"  fp32 loss: rank kernels {rank[0]:.7f}, plain rank attention "
        f"{plain[0]:.7f}, relative {d_loss:.2e} (tol {RANK_MATH_TOL})")
    if not ok:
        raise AssertionError("flash rank attention gradients differ from the "
                             "plain rank attention in fp32")
    return out


def rank_steps(cfg, spec, frozen, trainable, batch) -> dict:
    """Phase 11 at full depth: 2 warm-up and 3 timed steps under full remat
    (asserting 64 flash forward and 32 fused backward launches, 14 rank
    calls a layer forward, all rerun by the recompute, and their dq and
    dk/dv a step) with a traced step; then one ``proj_lse`` step, whose
    recompute reruns none of them."""
    n = cfg.n_layers
    calls = 2 * len(PROJS) * n  # 2 attending modalities, 7 projections
    run = train_steps(cfg, spec, frozen, clone_tree(trainable), batch,
                      busy=True, n_warm=2, n_timed=3)
    want = _launches(flash_fwd=2 * n, flash_bwd_fused=n,
                     flash_rank_fwd=2 * calls, flash_rank_bwd_dq=calls,
                     flash_rank_bwd_dkv=calls)
    if run["launches_per_step"] != want:
        raise AssertionError(f"flash rank step launches "
                             f"{run['launches_per_step']}, want {want}")
    lse = policy_ladder(cfg, spec, frozen, clone_tree(trainable), batch,
                        policies=("proj_lse",))["proj_lse"]
    want = {"flash_fwd": n, "flash_bwd_fused": n, "flash_rank_fwd": calls,
            "flash_rank_bwd_dq": calls, "flash_rank_bwd_dkv": calls}
    if lse["launches"] != want:
        raise AssertionError(f"flash rank proj_lse launches "
                             f"{lse['launches']}, want {want}")
    return {"full": run, "proj_lse": lse}


# ------------------------------------------------------------------- main

# ------------------------------------------------------------- phases 12-13

MM_FRAMES, MM_SEGMENTS, MM_AUDIO_FRAMES = 10, 10, 192  # a sample's groups
TOWER_TOL = 8e-2  # CLIP's last selected features through kernel 1 against
                  # the eager tower on the card, relative L2: both run the
                  # same int8 W8A8 products in bf16 and differ where
                  # attention rounds, which flips per-token int8 codes of
                  # later layers (2.9e-2 on an H100); the kernel run
                  # causal reads 0.21 there and must exceed it


def mm_config():
    """``avt_7b_int4a8f_qh_qenc_ta8f`` (``bench.py:407-412``): the AVT
    stack over LLaMA-2-7B (vocab 32011) with phase 9's spec (MokA AVT r=4,
    dropout 0.05, 256-key question window, bf16 dots), both towers int8
    with W8A8 dots, CLIP's attention through the flash kernel."""
    import dataclasses
    from moka_tpu_torch.models.unified import UnifiedConfig
    cfg, spec = quant_train_config()
    ucfg = UnifiedConfig.avt(cfg, spec)
    return dataclasses.replace(
        ucfg, clip=dataclasses.replace(ucfg.clip, a8_dots=True,
                                       use_flash=True),
        beats=dataclasses.replace(ucfg.beats, a8_dots=True))


def build_mm_stack(ucfg, llama_frozen, adapters, seed=7):
    """Phase 9's int4 base (int8 head) and adapters, with CLIP and BEATs
    built on the card in bf16 from ``seed`` and quantized by
    ``quantize_encoder(bits=8)``, and fp32 projectors."""
    import torch
    from moka_tpu_torch.models.beats import init_beats_params
    from moka_tpu_torch.models.clip_vit import init_clip_params
    from moka_tpu_torch.models.projectors import init_projector_params
    from moka_tpu_torch.ops.quant import quantize_encoder
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.bfloat16)
    frozen = {"llama": llama_frozen,
              "clip": quantize_encoder(init_clip_params(g, ucfg.clip, **kw)),
              "beats": quantize_encoder(init_beats_params(g, ucfg.beats,
                                                          **kw))}
    trainable = {"adapters": adapters,
                 "vl_projector": init_projector_params(
                     g, ucfg.vl_projector, device="cuda"),
                 "al_projector": init_projector_params(
                     g, ucfg.al_projector, device="cuda")}
    return frozen, trainable


def mm_batch(ucfg, b, L=None) -> dict:
    """With ``L``, ``bench.py::run_multimodal``'s samples (prefix, <video>,
    <audio>, a 16-token question, an answer filling the sample to about L,
    :239-254), padded to L; without, ``bench_decode.py::_mm_eval_batch``'s
    prompts (a 24-token question, no answer, :114-148), padded to the
    longest.  MM_FRAMES frames of 3x224x224 and MM_SEGMENTS fbank segments
    of MM_AUDIO_FRAMES x 128 a sample, on the card."""
    import torch
    from moka_tpu_torch.data import assembler as asm
    nv = MM_FRAMES * ucfg.vl_projector.num_query_tokens
    na = MM_SEGMENTS * ucfg.al_projector.num_query_tokens
    base = ucfg.llama.vocab_size - len(asm.SPECIAL_TOKENS)
    t2i = {t: base + i for i, t in enumerate(asm.SPECIAL_TOKENS)}
    rng = np.random.default_rng(0)
    samples = []
    for i in range(b):
        if L is not None:
            prefix = rng.integers(4, base, 16 + i).tolist()
            q_toks = rng.integers(4, base, 16).tolist()
            n_ans = max(1, L - (len(prefix) + 3 + nv + 3 + na + 2 +
                                len(q_toks)) - 8 - i)
            answer = rng.integers(4, base, n_ans).tolist()
        else:
            prefix = rng.integers(4, base, 16 + i % 8).tolist()
            q_toks = rng.integers(4, base, 24).tolist()
            answer = []
        ids = (prefix
               + [t2i["<video_start>"], t2i["<video>"], t2i["<video_end>"]]
               + [t2i["<audio_start>"], t2i["<audio>"], t2i["<audio_end>"]]
               + [t2i["<question_start>"]] + q_toks
               + [t2i["<question_end>"]] + answer)
        labels = [-100] * (len(ids) - len(answer)) + answer
        samples.append(asm.assemble_sample(
            np.asarray(ids), np.asarray(labels), t2i, pad_id=0,
            n_video_tokens=nv, n_audio_tokens=na))
    batch = asm.pad_batch(samples, pad_id=0, pad_to=L)
    img = ucfg.clip.image_size
    batch["video"] = rng.standard_normal(
        (b, MM_FRAMES, 3, img, img)).astype(np.float32)
    batch["audio"] = rng.standard_normal(
        (b, MM_SEGMENTS, MM_AUDIO_FRAMES, 128)).astype(np.float32)
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


@contextlib.contextmanager
def causal_clip_kernel():
    """Within: every flash forward launch runs its kernel with causal=1 (a
    deliberate fault of the CLIP tower's attention)."""
    from moka_tpu_torch.ops import flash_attention as fa
    launch = fa._launch_fwd

    def wrong(q, k, v, attn_mask, q_offset, causal):
        return launch(q, k, v, attn_mask, q_offset, True)

    fa._launch_fwd = wrong
    try:
        yield
    finally:
        fa._launch_fwd = launch


def check_clip_tower(ucfg, clip, video) -> dict:
    """CLIP's last selected features of every frame through kernel 1
    against the eager tower (the same int8 W8A8 products), relative L2
    within TOWER_TOL; the same with the kernel run causal must exceed it.
    Launches: one a layer that runs (the tower stops after the last
    selected layer)."""
    import dataclasses
    import torch
    from moka_tpu_torch.models.clip_vit import clip_hidden_states
    frames = video.reshape(-1, *video.shape[2:]).to(torch.bfloat16)
    sel = ucfg.select_layers
    with torch.inference_mode():
        _zero_counts()
        flash = clip_hidden_states(clip, ucfg.clip, frames, sel)[-1].float()
        launches = _counts()["flash_fwd_hd64"]
        eager = clip_hidden_states(clip, dataclasses.replace(
            ucfg.clip, use_flash=False), frames, sel)[-1].float()
        with causal_clip_kernel():
            wrong = clip_hidden_states(clip, ucfg.clip, frames,
                                       sel)[-1].float()
    err, fault = rel(flash, eager), rel(wrong, eager)
    finite = bool(torch.isfinite(flash).all())
    log(f"  CLIP tower {tuple(flash.shape)}: kernel vs eager rel L2 "
        f"{err:.3e}; kernel run causal vs eager {fault:.3e} (tol "
        f"{TOWER_TOL}; the causal run must exceed it); kernel-1 launches "
        f"{launches} ({max(sel)} layers run); finite {finite}")
    if launches != max(sel) or not finite or not err <= TOWER_TOL < fault:
        raise AssertionError("CLIP tower: the flash kernel's features "
                             "disagree with the eager tower's, or the check "
                             "passes a causal kernel")
    return {"rel_l2": err, "causal_fault_rel_l2": fault,
            "launches": launches}


def tower_times(ucfg, frozen, trainable, batch) -> dict:
    """ms of each stage of ``build_inputs_embeds`` on ``batch`` (the
    mean of three runs after one warm-up): the CLIP pass, the BEATs pass,
    both projectors, the splice."""
    import torch
    from moka_tpu_torch.data.assembler import splice_features
    from moka_tpu_torch.models import unified
    from moka_tpu_torch.models.beats import encode_audio_segments
    from moka_tpu_torch.models.clip_vit import encode_video
    from moka_tpu_torch.models.projectors import project_audio, \
        project_visual
    clip, beats = frozen["clip"], frozen["beats"]
    video = batch["video"].to(torch.bfloat16)
    audio = batch["audio"].to(torch.bfloat16)
    with torch.inference_mode():
        fv = encode_video(clip, ucfg.clip, video,
                          ucfg.select_layers)[-1].float()
        fa = encode_audio_segments(beats, ucfg.beats, audio).float()
        tv = project_visual(trainable["vl_projector"], ucfg.vl_projector, fv)
        ta = project_audio(trainable["al_projector"], ucfg.al_projector, fa)
        embeds = frozen["llama"]["embed"][batch["ids"].long()]
        few = dict(iters=3, warmup=1)
        out = {
            "clip_ms": time_ms(lambda: encode_video(
                clip, ucfg.clip, video, ucfg.select_layers), **few),
            "beats_ms": time_ms(lambda: encode_audio_segments(
                beats, ucfg.beats, audio), **few),
            "projectors_ms": time_ms(lambda: (
                project_visual(trainable["vl_projector"], ucfg.vl_projector,
                               fv),
                project_audio(trainable["al_projector"], ucfg.al_projector,
                              fa)), **few),
            "splice_ms": time_ms(lambda: splice_features(
                embeds, tv, batch["video_pos"], ta, batch["audio_pos"]),
                **few),
            "build_inputs_embeds_ms": time_ms(
                lambda: unified.build_inputs_embeds(trainable, frozen, ucfg,
                                                    batch), **few)}
    log("  " + ", ".join(f"{k[:-3]} {v:.2f} ms" for k, v in out.items()) +
        f" (b {video.shape[0]}, {video.shape[1]} frames, "
        f"{audio.shape[1]} segments)")
    return out


def mm_generate(ucfg, frozen, trainable, batch_size=8,
                new_tokens=32) -> dict:
    """Phase 12: ``unified.generate`` on ``bench_decode.py::main_mm``'s
    batch (b 8, greedy, no end token).  Checks the CLIP tower (kernel 1 at
    head_dim 64) and the multimodal prefill logits (phase 4's rule: the
    kernel path within LOGIT_RATIO of the plain path's distance from
    fp32); times the stages, prefill (1 new token) and ``new_tokens`` (the
    main path: launch counts zeroed just before, read just after)."""
    import torch
    from moka_tpu_torch.models import llama, unified
    batch = mm_batch(ucfg, batch_size)
    tower = check_clip_tower(ucfg, frozen["clip"], batch["video"])
    with torch.inference_mode():
        embeds = unified.build_inputs_embeds(trainable, frozen, ucfg, batch)
    inputs = {"inputs_embeds": embeds, "prompt_mask": batch["attn_mask"],
              "masks": llama.MaskBundle(batch["modality_masks"],
                                        batch["question_mask"])}
    log(f"  prompts b {batch_size} L {embeds.shape[1]} "
        f"({int(batch['video_pos'].shape[1] + batch['audio_pos'].shape[1])}"
        f" multimodal tokens a prompt):")
    check_logits(ucfg.llama, ucfg.spec, frozen["llama"],
                 trainable["adapters"], inputs, new_tokens)
    del embeds, inputs
    stages = tower_times(ucfg, frozen, trainable, batch)

    def gen(n):
        return unified.generate(trainable, frozen, ucfg, batch,
                                max_new_tokens=n, eos_id=-1)

    n_clip = max(ucfg.select_layers)
    out = main_path(gen, batch_size, new_tokens, ucfg.llama.vocab_size,
                    _launches(flash_fwd=ucfg.llama.n_layers + n_clip,
                              flash_fwd_hd64=n_clip,
                              moka_delta_fwd=7 * ucfg.llama.n_layers),
                    f"unified.generate b {batch_size}")
    out.update(tower_check=tower, **stages,
               prefill_after_towers_ms=out["prefill_ms"] -
               stages["build_inputs_embeds_ms"],
               encoder_inclusive_tok_s=batch_size * new_tokens /
               (out["total_ms"] / 1e3))
    log(f"  encoder-inclusive {out['encoder_inclusive_tok_s']:.1f} new "
        f"tokens/s; prefill after the towers, projectors and splice "
        f"{out['prefill_after_towers_ms']:.1f} ms")
    return out


MM_LOSS_FLOOR = 2e-3  # nats: the 2-layer multimodal loss's bf16 noise; the
                      # plain bf16 path reads 1.76e-3 from fp32 on an H100
                      # and the kernel path 3.19e-3, which also carries the
                      # tower's int8 code flips (TOWER_TOL)
MM_LOSS = dict(remat=True, fused_loss=True, remat_policy="qkvod_lse",
               a8_dots="full")  # bench.py:407-412 with use_flash


def mm_loss(ucfg, kernels: bool):
    """The multimodal step's loss: through the flash kernels (the decoder
    and the CLIP tower), or on the plain path (eager attention in both)."""
    import dataclasses
    from moka_tpu_torch.models.unified import unified_loss
    if not kernels:
        ucfg = dataclasses.replace(ucfg, clip=dataclasses.replace(
            ucfg.clip, use_flash=False))
    return unified_loss(ucfg, use_flash=kernels, **MM_LOSS)


def _paths(tree, prefix=()):
    """Key paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def mm_loss_and_grads(ucfg, frozen, trainable, batch, kernels, key):
    """(loss, {group: its gradients, flat}): a group per adapter projection
    and per projector (the Q-Formers' text branch, which no question
    reaches, in zeros)."""
    import torch
    from moka_tpu_torch.train.optim import tree_leaves
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = mm_loss(ucfg, kernels)(trainable, frozen, batch, key)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    flat = {}
    for path, g in zip(_paths(trainable), grads):
        group = path[2] if path[0] == "adapters" else path[0]
        flat.setdefault(group, []).append(g.flatten())
    return float(loss.detach()), {k: torch.cat(v) for k, v in flat.items()}


def check_mm_grads(ucfg, frozen, trainable, batch) -> dict:
    """At SHALLOW decoder layers with the full towers: the loss and the
    gradients of every adapter projection and both projectors through the
    kernels, against the plain path (eager attention in the decoder and
    the CLIP tower) and an fp32 run (the same values in fp32, integer codes
    kept), same dropout key, under phase 6's rule; the loss's floor is
    MM_LOSS_FLOOR nats."""
    import dataclasses
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    n = SHALLOW
    ucfg = dataclasses.replace(ucfg, llama=dataclasses.replace(
        ucfg.llama, n_layers=n))
    frozen = dict(frozen, llama=first_layers(frozen["llama"], n))
    trainable = dict(trainable,
                     adapters=first_layers(trainable["adapters"], n))
    key = DropoutKey(14)
    kern = mm_loss_and_grads(ucfg, frozen, trainable, batch, True, key)
    plain = mm_loss_and_grads(ucfg, frozen, trainable, batch, False, key)
    frozen32 = float32(frozen)
    exact = mm_loss_and_grads(ucfg, frozen32, trainable, batch, False, key)
    del frozen32
    torch.cuda.empty_cache()
    out = {"loss": {"kernels": kern[0], "plain": plain[0], "fp32": exact[0]},
           "grad_rel_l2": {}}
    dk, dp = abs(kern[0] - exact[0]), abs(plain[0] - exact[0])
    ok = all(math.isfinite(x) for x in out["loss"].values()) and \
        dk <= TRAIN_RATIO * dp + MM_LOSS_FLOOR
    log(f"  {n} decoder layers, full towers: loss kernels {kern[0]:.6f}, "
        f"plain {plain[0]:.6f}, fp32 {exact[0]:.6f} (|kernels - fp32| "
        f"{dk:.3e} vs plain {dp:.3e}, ratio {dk / dp:.2f}; tol "
        f"{TRAIN_RATIO} x plain + {MM_LOSS_FLOOR} nats)")
    for name in kern[1]:
        ek = rel(kern[1][name], exact[1][name])
        ep = rel(plain[1][name], exact[1][name])
        good = bool(torch.isfinite(kern[1][name]).all()) and \
            ek <= TRAIN_RATIO * ep + TRAIN_FLOOR
        ok &= good
        out["grad_rel_l2"][name] = {
            "kernels_vs_fp32": ek, "plain_vs_fp32": ep,
            "kernels_vs_plain": rel(kern[1][name], plain[1][name])}
        log(f"  grad {name}: rel L2 vs fp32 kernels {ek:.3e}, plain "
            f"{ep:.3e}; norm {float(exact[1][name].norm()):.3e}"
            f"{'' if good else '  <-- FAIL'}")
    log(f"  (tol: kernels <= {TRAIN_RATIO} x plain + {TRAIN_FLOOR})")
    if not ok:
        raise AssertionError("multimodal step: the kernel path is further "
                             "from fp32 than the plain bf16 path allows")
    return out


def mm_steps(ucfg, frozen, trainable) -> dict:
    """Phase 13: ``bench.py::run_multimodal``'s step on the stack (b 4 x
    L 1024, MM_LOSS, ``make_optimizer(TrainConfig(), 1000)``, the
    trainable tree {adapters, vl_projector, al_projector}): the SHALLOW
    gradient check, then at full depth 2 warm-up and 5 timed steps with a
    traced one; launches a step asserted; the towers' forward ms at b 4."""
    import torch
    batch = mm_batch(ucfg, 4, L=1024)
    check = check_mm_grads(ucfg, frozen, trainable, batch)
    stages = tower_times(ucfg, frozen, trainable, batch)
    run = train_steps(ucfg.llama, ucfg.spec, frozen, clone_tree(trainable),
                      batch, busy=True, loss_fn=mm_loss(ucfg, True))
    n_clip, n = max(ucfg.select_layers), ucfg.llama.n_layers
    want = _launches(flash_fwd=n + n_clip, flash_fwd_hd64=n_clip,
                     flash_bwd_fused=n)
    log(f"  step min {run['step_ms_min']:.1f} ms, median "
        f"{run['step_ms']:.1f} ms")
    if run["launches_per_step"] != want:
        raise AssertionError(f"multimodal step launches "
                             f"{run['launches_per_step']}, want {want}")
    if not run["losses"][-1] < run["losses"][0]:
        raise AssertionError(f"the loss did not fall: {run['losses']}")
    torch.cuda.empty_cache()
    return {"check": check, "stages_b4": stages, **run}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "moka_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from moka_tpu_torch import kernels
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.ops.moka import MokaSpec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s); nvidia-smi name, power.limit:")
    log(smi)

    import profile_port
    t0 = time.perf_counter()
    mutants = {name: profile_port.start_variants(src, edits)
               for name, (src, edits) in MUTANT_SOURCES.items()}
    built = kernels.build()
    for name, procs in mutants.items():
        MUTANTS[name] = profile_port.finish_variants(procs)
    log(f"[2] built {sorted(built)} and the mutants "
        f"{ {n: sorted(v) for n, v in MUTANTS.items()} } in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in kernels.SOURCES:
        text = (kernels.BUILD_DIR / f"{name}.log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "setmaxnreg" in line or "C75" in line:
                    log(f"    {name}: {line.strip()}")
    check_flash_sass()
    check_ce_sass()
    check_bd_rank_sass()

    cfg = LlamaConfig.llama2_7b()
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    batch, prompt_len, new_tokens = 8, 896, 32
    log("[3] kernels against their plain versions")
    records = [flash_record(batch, prompt_len, prompt_len + new_tokens),
               moka_record(batch, prompt_len, cfg.dim, cfg.intermediate),
               *flash_bwd_records(),
               *dropout_records(4 * 1024, cfg.dim, cfg.intermediate),
               *ce_records(4 * 1023, cfg.dim, 32011),
               *block_diag_records(), *rank_flash_records(4, 1024),
               clip_flash_record()]
    mm_prefill_checks(records, new_tokens)
    torch.cuda.empty_cache()

    log(f"[4] LLaMA-2-7B + MokA AVT r4 at full width, {cfg.n_layers} layers")
    base, adapters = build_model(cfg, spec)
    inputs = main_path_inputs(cfg, base, batch, prompt_len)
    check_logits(cfg, spec, base, adapters, inputs, new_tokens)
    timings = main_path(
        lambda n: generate(cfg, spec, base, adapters, inputs, n), batch,
        new_tokens, cfg.vocab_size,
        _launches(flash_fwd=cfg.n_layers, moka_delta_fwd=7 * cfg.n_layers),
        f"greedy_generate b {batch} prompt {prompt_len}")

    log("[5] HTTP serving over the continuous-batching engine")
    served = serve_requests(cfg, spec, base, adapters, new_tokens=new_tokens)
    if min(served["launches"][k] for k in ("flash_fwd", "moka_delta_fwd")) \
            <= 0:
        raise AssertionError("serving did not launch the kernels")

    log(f"[10] BOFT merge and serve: BoftSpec(8, 2) on all "
        f"{7 * cfg.n_layers} projections of phase 4's base, then its prefill")
    boft = boft_merge_and_serve(cfg, spec, base, adapters, inputs, new_tokens)
    del base, adapters, inputs
    gc.collect()
    torch.cuda.empty_cache()

    tcfg, tspec = train_config()
    log(f"[6] training step: LLaMA-2-7B (vocab {tcfg.vocab_size}) + MokA AVT "
        f"r4 dropout {tspec.dropout_rate}, full remat, {tcfg.n_layers} "
        f"layers, b 4 L 1024")
    frozen, trainable = build_trainer(tcfg, tspec)
    batch = train_batch(tcfg, 4, 1024)
    train_check = check_train_grads(tcfg, tspec, frozen, trainable, batch)
    train = train_steps(tcfg, tspec, frozen, trainable, batch)
    want = _launches(flash_fwd=2 * tcfg.n_layers,
                     flash_bwd_fused=tcfg.n_layers)
    if train["launches_per_step"] != want:
        raise AssertionError(f"training step launches "
                             f"{train['launches_per_step']}, want {want}")

    log("[7] long-context training step: b 1 L 4096, dynamic-NTK RoPE")
    long_step = long_context_step(frozen, trainable)

    fcfg, fspec = fused_train_config()
    log(f"[8] fused-dropout training step: the same model, bf16 dots, fused "
        f"dropout (kernels 6-7), remat policy proj_lse, b 4 L 1024")
    fused_check = check_fused_train_grads(fcfg, fspec, frozen, trainable,
                                          batch)
    fused = train_steps(fcfg, fspec, frozen, trainable, batch,
                        policy="proj_lse", busy=True)
    n_proj = 7 * fcfg.n_layers
    want = _launches(flash_fwd=fcfg.n_layers, flash_bwd_fused=fcfg.n_layers,
                     dropout_a_fwd=2 * n_proj, dropout_a_bwd=n_proj)
    if fused["launches_per_step"] != want:
        raise AssertionError(f"fused-dropout step launches "
                             f"{fused['launches_per_step']}, want {want}")
    if not fused["losses"][-1] < fused["losses"][0]:
        raise AssertionError(f"the loss did not move: {fused['losses']}")
    log("  policy ladder (one step each, fused dropout):")
    ladder = policy_ladder(fcfg, fspec, frozen, trainable, batch)

    rcfg, rspec = rank_train_config()
    log(f"[11] flash rank attention step: phase 6's model and batch with "
        f"flash_rank_attn (the rank kernels, head_dim 4 fp32), full remat, "
        f"b 4 L 1024")
    rank_check = check_rank_train_grads(rcfg, rspec, frozen, trainable,
                                        batch)
    rank = rank_steps(rcfg, rspec, frozen, trainable, batch)
    log(f"  against phase 6's step in this call: {rank['full']['step_ms']:.1f}"
        f" vs {train['step_ms']:.1f} ms, peak "
        f"{rank['full']['peak_memory_bytes'] / 2**30:.2f} vs "
        f"{train['peak_memory_bytes'] / 2**30:.2f} GiB; busy share "
        f"{rank['full']['busy_share']:.3f}; proj_lse step "
        f"{rank['proj_lse']['step_ms']:.1f} ms, peak "
        f"{rank['proj_lse']['peak_memory_bytes'] / 2**30:.2f} GiB")
    del frozen, trainable
    gc.collect()
    torch.cuda.empty_cache()

    qcfg, qspec = quant_train_config()
    log(f"[9] quantized training step (llama2_7b_int4a8_qh_sq8_plse): int4 "
        f"base, int8 head, a8_dots full, save_q8, proj_lse, bf16 dots, "
        f"{qcfg.n_layers} layers, b 4 L 1024")
    from moka_tpu_torch.ops.quant import quantized_bytes
    t0 = time.perf_counter()
    qfrozen, qtrain = build_quant_trainer(qcfg, qspec)
    torch.cuda.synchronize()
    log(f"  built on the card in {time.perf_counter() - t0:.1f} s: frozen "
        f"tree {quantized_bytes(qfrozen) / 2**30:.2f} GiB")
    quant_check = check_quant_train_grads(qcfg, qspec, qfrozen, qtrain,
                                          batch)
    quant = quant_steps(qcfg, qspec, qfrozen, qtrain, batch,
                        fused["peak_memory_bytes"])
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    ucfg = mm_config()
    log(f"[12] multimodal generate (bench_decode.py::main_mm): CLIP "
        f"ViT-L/14 and BEATs (int8, W8A8 dots, CLIP through kernel 1 at "
        f"head_dim 64), both Q-Former projectors and the splice, on phase "
        f"9's int4 base (int8 head) and adapters, b 8, {MM_FRAMES} frames, "
        f"{MM_SEGMENTS} audio segments of {MM_AUDIO_FRAMES} frames, 32 new "
        f"tokens")
    mfrozen, mtrain = build_mm_stack(ucfg, qfrozen, qtrain["adapters"])
    mm_gen = mm_generate(ucfg, mfrozen, mtrain)
    log(f"[13] multimodal fine-tune step (bench.py::run_multimodal, "
        f"avt_7b_int4a8f_qh_qenc_ta8f): qkvod_lse, a8_dots full, chunked "
        f"CE on the a8 head, b 4 L 1024, {ucfg.llama.n_layers} layers")
    mm_train = mm_steps(ucfg, mfrozen, mtrain)

    paths = {"serving main path (greedy_generate)": timings["launches"],
             "training step": train["launches_per_step"],
             "long-context training step": long_step["launches"],
             "fused-dropout training step (proj_lse)":
                 fused["launches_per_step"],
             "quantized step, route B (pallas_ce)":
                 quant["B"]["launches_per_step"],
             "quantized step, route A (a8 head)":
                 quant["A"]["launches_per_step"],
             "BOFT merge": boft["launches"],
             "flash rank attention step": rank["full"]["launches_per_step"],
             "multimodal generate (unified.generate)": mm_gen["launches"],
             "multimodal step": mm_train["launches_per_step"]}
    own = {"flash_fwd": "serving main path (greedy_generate)",
           "moka_delta_fwd": "serving main path (greedy_generate)",
           "flash_bwd_fused": "training step",
           "flash_bwd_dq": "long-context training step",
           "flash_bwd_dkv": "long-context training step",
           "dropout_a_fwd": "fused-dropout training step (proj_lse)",
           "dropout_a_bwd": "fused-dropout training step (proj_lse)",
           "fused_ce_fwd": "quantized step, route B (pallas_ce)",
           "fused_ce_bwd": "quantized step, route B (pallas_ce)",
           "block_diag": "BOFT merge",
           "flash_rank_fwd": "flash rank attention step",
           "flash_rank_bwd_dq": "flash rank attention step",
           "flash_rank_bwd_dkv": "flash rank attention step",
           "flash_fwd_hd64": "multimodal generate (unified.generate)"}
    for rec in records:
        rec["launches"] = int(paths[own[rec["name"]]][rec["name"]])
        rec["launches_path"] = own[rec["name"]]
        rec["launches_by_path"] = {p: c.get(rec["name"], 0) for p, c in
                                   paths.items()}
    log(json.dumps({"main_path": timings, "serving": served,
                    "train_check": train_check, "train": train,
                    "long_context": long_step, "fused_check": fused_check,
                    "fused_train": fused, "policy_ladder": ladder,
                    "quant_check": quant_check, "quant_train": quant,
                    "boft": boft, "rank_check": rank_check,
                    "rank_train": rank, "mm_generate": mm_gen,
                    "mm_train": mm_train}))
    log(f"[14] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
