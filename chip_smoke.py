#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``moka_tpu_torch``) on one H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, in order; any failed build, launch or check exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from ``moka_tpu_torch/kernels/csrc`` (nvcc,
     sm_90a, one process per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, with its
     time, the plain version's time, the library call's time (flash only:
     ``scaled_dot_product_attention``, never called by the port) and the
     least time the card could take (the bound);
  4. LLaMA-2-7B (bf16 base, random weights from a seed) with MokA AVT r=4
     adapters (B seeded non-zero) at full width and depth: the logits of
     ``greedy_generate``'s prefill of the whole batch through the kernels
     against the plain path, then ``greedy_generate`` timed for 1 and 32
     new tokens (the latter is the main path: launch counts are zeroed
     before it and read after);
  5. ``serve_continuous`` over a ``DecodeEngine``: three concurrent
     /generate requests of different prompt buckets and one
     /generate_stream request, each answered with its full token count;
  6. one JSON line with every kernel's numbers, then the card's line.
fp32 matmuls and convolutions run in full fp32 (TF32 off).  The script
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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
MOKA_TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # of max|plain|: one bf16
                      # rounding of the output (2^-8) / fp32 summation order
LOGIT_RATIO = 1.5  # prefill logits: the kernel path's distance from an fp32
                   # run may exceed the plain bf16 path's by half: both only
                   # round differently (+1e-3 / 1e-2 of the logit std)


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


def bound_ms(n_bytes: float, n_ops: float, peak: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ phase 3

def _visible(mask, L, S, q_offset):
    """(b, L, S) bool: causal + padding visibility."""
    import torch
    qpos = torch.arange(L, device=mask.device)[:, None] + q_offset
    causal = qpos >= torch.arange(S, device=mask.device)[None, :]
    return causal[None] & (mask[:, None, :] > 0)


def flash_case(b, H, KH, L, S, pads=None, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, L, H, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, S, KH, 128), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, S, KH, 128), generator=g, device="cuda").bfloat16()
    mask = torch.ones((b, S), dtype=torch.int32, device="cuda")
    for i, p in enumerate(pads or ()):
        mask[i, :p] = 0
    return q, k, v, mask


def check_flash(name, q, k, v, mask, q_offset=0) -> float:
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    import torch
    out, lse = flash_fwd(q, k, v, mask, q_offset)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_plain(q, k, v, mask, q_offset)
    L, S = q.shape[1], k.shape[1]
    rows = _visible(mask, L, S, q_offset).any(dim=-1)  # (b, L) valid rows
    atol, rtol = FLASH_OUT_TOL
    diff = (out.float() - ref.float()).abs() * rows[:, :, None, None]
    excess = float((diff - rtol * ref.float().abs()).max())
    d_out = float(diff.max())
    d_lse = float(((lse - ref_lse).abs().amax(dim=1) * rows).max())
    ok = excess <= atol and d_lse <= FLASH_LSE_TOL
    log(f"  flash {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"q_offset {q_offset}: max|out err| {d_out:.3e}, max(|err| - "
        f"{rtol:.4g}|plain|) {excess:.3e} (tol {atol}), max|lse err| "
        f"{d_lse:.3e} (tol {FLASH_LSE_TOL}), valid rows "
        f"{int(rows.sum())}/{rows.numel()}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version "
                             f"({name})")
    return d_out


def flash_record(b, L, S) -> dict:
    """Check kernel A at the issue shapes and time it at the main path's
    prefill shape (b, L, S)."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    err = 0.0
    err = max(err, check_flash("slice shape", *flash_case(8, 32, 32, 896,
                                                          1024)))
    err = max(err, check_flash("GQA 32:8", *flash_case(2, 32, 8, 512, 512,
                                                       seed=1)))
    err = max(err, check_flash("q_offset", *flash_case(2, 32, 32, 128, 1024,
                                                       seed=2),
                               q_offset=896))
    err = max(err, check_flash(
        "left pad + ragged L", *flash_case(4, 32, 32, 333, 333, seed=3,
                                           pads=(0, 17, 64, 100))))
    q, k, v, mask = flash_case(b, 32, 32, L, S, seed=4)
    err = max(err, check_flash("main path shape", q, k, v, mask))
    ms = time_ms(lambda: flash_fwd(q, k, v, mask))
    plain_ms = time_ms(lambda: flash_fwd_plain(q, k, v, mask))
    vis = _visible(mask, L, S, 0)
    bool_mask = vis[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bool_mask))
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
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "moka_tpu/ops/flash_attention.py:56",
            "launches": None, "max_abs_err": err,
            "tolerance": "|err| <= %g + %g |plain|" % FLASH_OUT_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
            "shape": f"b {b} H 32 L {L} S {S} hd 128, one layer"}


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


def check_logits(cfg, spec, base, adapters, inputs, new_tokens) -> None:
    """Logits of the whole batch's prefill, run by ``decode.prefill`` as
    ``greedy_generate`` runs it (same cache size and cache mask): with both
    kernels, on the plain bf16 path, and on the plain path in fp32 on the
    same (bf16-valued) weights.  Fails unless the kernel path is within
    LOGIT_RATIO times the plain bf16 path's distance from fp32."""
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
        plain = logits(base, False, torch.bfloat16)
        base32 = {k: ({n: t.float() for n, t in v.items()}
                      if isinstance(v, dict) else v.float())
                  for k, v in base.items()}
        exact = logits(base32, False, torch.float32)
        del base32
    log(f"  kernel prefill: flash launches {counts[0]}, fused MokA "
        f"launches {counts[1]}")
    if counts != (cfg.n_layers, 7 * cfg.n_layers):
        raise AssertionError(f"prefill launches {counts}")
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


def main_path(cfg, spec, base, adapters, inputs, new_tokens) -> dict:
    """Times ``greedy_generate`` for one token (the prefill and the head on
    its last row, no decode step; median of three) and for ``new_tokens``
    (the main path: launch counts zeroed just before, read just after).
    Decode = the difference; its cache is new_tokens - 1 positions longer."""
    import torch
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(cfg, spec, base, adapters, inputs, n)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    with torch.inference_mode():
        generate(cfg, spec, base, adapters, inputs, new_tokens)  # warm-up
        prefill_s = sorted(timed(1)[1] for _ in range(3))[1]
        flash_fwd.launches = moka_delta_fused.launches = 0
        toks, total_s = timed(new_tokens)
        launches = {"flash_fwd": flash_fwd.launches,
                    "moka_delta_fwd": moka_delta_fused.launches}
    batch = inputs["inputs_embeds"].shape[0]
    if tuple(toks.shape) != (batch, new_tokens) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    tps = batch * (new_tokens - 1) / (total_s - prefill_s)
    log(f"  greedy_generate b {batch} prompt "
        f"{inputs['inputs_embeds'].shape[1]} new {new_tokens}: total "
        f"{total_s * 1e3:.1f} ms, prefill (1 new token) {prefill_s * 1e3:.1f}"
        f" ms, decode {tps:.1f} tok/s ({new_tokens - 1} decode steps), "
        f"launches {launches}")
    if launches != {"flash_fwd": cfg.n_layers,
                    "moka_delta_fwd": 7 * cfg.n_layers}:
        raise AssertionError(f"main path launches {launches}")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "decode_tok_s": tps, "total_ms": total_s * 1e3}


# ------------------------------------------------------------------ phase 5

def serve_requests(cfg, spec, base, adapters, n_slots=8,
                   capacity=2048, new_tokens=32,
                   prompt_lens=(100, 300, 700), stream_len=200,
                   bucket=128) -> dict:
    import torch
    from moka_tpu_torch.eval.engine import DecodeEngine
    from moka_tpu_torch.eval.server import serve_continuous
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused

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
    flash_fwd.launches = moka_delta_fused.launches = 0
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
    launches = {"flash_fwd": flash_fwd.launches,
                "moka_delta_fwd": moka_delta_fused.launches}
    log(f"  served {len(jobs)} requests in {wall:.2f} s: tokens "
        f"{ {f'{p} {n}': c for (p, n), c in results.items()} }, launches "
        f"{launches}")
    if any(t.is_alive() for t in threads) or len(results) != len(jobs) or \
            any(c != new_tokens for c in results.values()):
        raise AssertionError(f"serving: wrong token counts {results}")
    return {"wall_s": wall, "launches": launches}


# ------------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
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

    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in kernels.SOURCES:
        text = (kernels.BUILD_DIR / f"{name}.log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {name}: {line.strip()}")

    cfg = LlamaConfig.llama2_7b()
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    batch, prompt_len, new_tokens = 8, 896, 32
    log("[3] kernels against their plain versions")
    records = [flash_record(batch, prompt_len, prompt_len + new_tokens),
               moka_record(batch, prompt_len, cfg.dim, cfg.intermediate)]

    log(f"[4] LLaMA-2-7B + MokA AVT r4 at full width, {cfg.n_layers} layers")
    base, adapters = build_model(cfg, spec)
    inputs = main_path_inputs(cfg, base, batch, prompt_len)
    check_logits(cfg, spec, base, adapters, inputs, new_tokens)
    timings = main_path(cfg, spec, base, adapters, inputs, new_tokens)
    for rec in records:
        rec["launches"] = timings["launches"][rec["name"]]

    log("[5] HTTP serving over the continuous-batching engine")
    served = serve_requests(cfg, spec, base, adapters, new_tokens=new_tokens)
    if min(served["launches"].values()) <= 0:
        raise AssertionError("serving did not launch the kernels")

    log(json.dumps({"main_path": timings, "serving": served}))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
