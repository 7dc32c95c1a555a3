#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``moka_tpu_torch``) on one H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, in order; any failed build, launch or check exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``moka_tpu_torch/kernels/csrc`` (nvcc,
     sm_90a, one process per source, in parallel) and, beside them, the
     deliberate faults RANK_MUTANTS, RANK_BWD_MUTANTS, BD_MUTANTS,
     MOKA_MUTANTS, DROP_MUTANTS, CE_FWD_MUTANTS and DECODE_MUTANTS
     (edited copies of the rank kernels', kernel 10's, kernel 5's, kernels
     6-7's, kernel 8's and the decode kernel's sources), print ptxas's
     resource lines
     and the SASS counts of the flash kernels, the fused CE pair, the rank
     kernels, kernel 10, kernel 5, kernels 6-7 and the decode kernel
     (``cuobjdump -sass``: a decode instance without UTMALDG or HMMA, or
     an int8 one with more I2F than the bf16 one, fails the phase; a
     forward instance, the dq kernel or a key-major backward kernel
     without HGMMA or UTMALDG or with HMMA, the fused backward without its
     bulk reduction, kernel 9 without HGMMA, UTMALDG or a bulk reduction
     or with HMMA, an instance of kernel 10 without UTMALDG, an instance
     of kernel 5's bf16 kernel without HGMMA, UTMALDG or UTMASTG, or an
     instance of kernel 6's or 7's bf16-x kernel without HGMMA or UTMALDG
     (7 also UTMASTG) or with HMMA, or an instance of the rank dq or
     dk/dv kernel with an atomic (ATOM, RED) fails the phase; kernel 8
     keeps mma.sync, the rank kernels and kernels 6-7's fp32-x path are
     SIMT);
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
     is_causal); the fused MokA delta (kernel 5) at ranks 4, 8 and 16,
     AVT and VT, bf16 and fp32 x, on the serving masks, a question mask
     with gaps and a row with no question token, more question keys than
     one shared-memory stage, and phase 12's prefill masks, timed at each
     rank (the kernel alone in a CUDA graph, and back to back), and
     launched as each MOKA_MUTANTS fault (the attention term dropped,
     only the first key chunk walked) it must fail; the three backward
     kernels also at S % 128 != 0,
     non-causal with padded keys, and on a ring attention key shard at a
     negative q_offset with the global rows' lse and delta (part of the
     shard visible; all of it masked, where dq, dk and dv must be exactly
     zero), and the fused and dq kernels launched with causal flipped
     must fail the check; the fused dropout kernels
     (6-7) at every M*r of ranks 4, 8, 16 x 1-4 modalities (4-64; phase
     19 the wider ones)
     at the training path's (4096, 4096) and (4096, 11008) with fp32 and
     bf16 A, in Philox and forced-words modes, and at a ragged (333, 200)
     with fp32 and bf16 x, masks held exactly and repeats bit-identical,
     launched as each DROP_MUTANTS fault (the backward's words at the
     neighbouring counter, dA over half the rows, the forward without its
     mask) they must fail, timed over a layer's seven projections at AVT
     ranks 4, 8 and 16; the fused CE
     kernels (8-9) on an int8 head at route B's shape and three ragged
     ones (kernel 9 also timed without the wrapper's zero fill and cast);
     the block-diagonal product (kernel 10) at the BOFT merge's three
     shapes, at b 16, 24 and 32 and with fp32 x, 100 launches at b 8
     with fp32 x all alike, and launched as a mutant
     that reads each block transposed, which must fail (timed cold, x
     rotated past the L2 cache, and warm; library: ``torch.bmm``); the
     rank flash kernels (1-4 at head_dim 4, fp32) at the training step's
     (b 4, L 1024) with a sample that sees no key, on the forward's key
     layouts (a span in the last 256-key tile, one across a 256-key
     boundary, two spans, none; also at head_dim 16), causal at a
     q_offset that leaves rows before the first visible key, and at a
     ragged L, the backward on the forward kernel's lse, dq exactly 0 on
     the rows that see no key, dk and dv on the keys no query sees, and
     a second backward launch bit-identical; the forward launched as each
     mutant (it walks only the first visible 256-key tile; it gives 0 to
     a row that sees no key) and the backward as each (dq walks only the
     first 32 keys of the span; dk/dv sums only the first query chunk,
     zeroes a visible key, walks one key block a CTA, adds only the first
     warp's queries) must fail
     (timed: the
     wrapper back to back, the kernel alone in a CUDA graph, the host's
     µs a call); kernel 1 at the CLIP
     tower's shape (b*t 40 and 80 frames, 257 tokens, 16 heads, head_dim
     64, non-causal, every key valid) and a ragged one with padded keys
     (library: ``scaled_dot_product_attention`` without a mask); the
     decode kernel (``paged_decode.cu``) at DECODE_CASES (the 7B serving
     shape b 8, S 1024, length 928 with pads 0-6 and a row without keys;
     infer's and eval_vt's cache, S 1280, length 1025: the last 64-key
     tile holding one key; the llama2_70b heads, GQA 64:8; one 256-key
     block; one sample, S 4096, length 3000: eight spans a pair merged in
     the launch), on bf16 and int8 caches with a poisoned tail, rows
     without keys reading 0, and on both 7B serving cases and the
     one-sample case 20 repeats bit-identical and the mutants
     (DECODE_MUTANTS: vs dropped, a span's last tile never loaded, and,
     on the one-sample case, the last span left out of the merge)
     failing; timed at the 7B serving shape, infer's cache and GQA 64:8
     (the wrapper back to back, the kernel alone in a CUDA graph, the
     host's µs a call; library: SDPA over the valid prefix with the
     boolean mask, the int8 prefix dequantized first);
  4. LLaMA-2-7B (bf16 base, random weights from a seed) with MokA AVT r=4
     adapters (B seeded non-zero) at full width and depth: the logits of
     ``greedy_generate``'s prefill of the whole batch through the kernels
     against the plain path, then ``greedy_generate`` timed for 1 and 32
     new tokens (the latter is the main path: launch counts are zeroed
     before it and read after); then a rank-8 adapter tree on the same
     base (what ``moka_tpu/cli/infer.py --lora-r 8`` serves): the prefill
     logits under the same rule, ``greedy_generate`` and one ``DecodeEngine``
     request with their defaults, each through kernel 5 (224 launches a
     prefill); then ``greedy_generate`` with ``paged_decode`` on a bf16
     and an int8 cache (32 decode-kernel launches a decode step), and the
     decode logits teacher-forced on the eager bf16 path's tokens: paged
     against eager on the same cache within KV_KERNEL_TOL, the int8 cache
     against the bf16 one within KV8_LOGIT_TOL, the decode kernel's
     mutants beyond both; every decode path's launch counts include the decode kernel
     where ``paged_decode_auto`` takes it;
  5. ``serve_continuous`` over a ``DecodeEngine``: three concurrent
     /generate requests of different prompt buckets and one
     /generate_stream request, each answered with its full token count;
  6. training (bench.py's 7B row with a bf16 base: vocab 32011, MokA AVT
     r=4 with dropout 0.05, full remat, flash, chunked CE, AdamW with
     warmup + cosine) at b 4, L 1024, full width and depth: the loss and
     every projection's adapter gradients through the kernels against the
     plain attention and an fp32 run, then 2 warm-up and 2 timed steps of
     ``make_train_step`` (launch counts zeroed before the timed steps and
     read after: 64 flash forward, 32 fused backward a step);
  7. one long-context step (b 1, L 4096, dynamic-NTK RoPE, full depth),
     which runs the dq + dkv backward pair (32 launches each);
  8. the fused-dropout step (phase 6's model and batch with bf16 dots,
     fused dropout and remat policy ``proj_lse``): at 2 layers the kernel
     path's gradients against the plain path (same Philox masks) and fp32,
     proj_lse against full remat, and the same gradient check on an AVT
     rank-8 tree (M*r 24) and a VT tree (M*r 8); then 2 warm-up and 2
     timed steps
     (32 flash forward, 32 fused backward, 448 dropout forward and 224
     dropout backward launches a step), one traced step for the device's
     busy share (``profile_port.trace``), and one step under each of full,
     qkvod_lse, proj_nokv_lse and proj_lse (step time, peak memory);
  9. the shipping quantized recipe (``llama2_7b_int4a8_qh_sq8_plse``:
     int4 base and int8 head built on the card, a8_dots "full", save_q8,
     proj_lse, bf16 dots): at 2 layers route B's gradients (flash and the
     fused CE kernels 8-9) against the plain path and fp32; route B
     (``pallas_ce``) for 2 + 3 steps (32 flash forward, 32 fused backward,
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
     2 timed steps (64 flash forward, 32 fused backward, 896 rank forward,
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
     the plain path and fp32 (phase 6's rule), then 2 warm-up and 2 timed
     steps with a traced one (55 flash forward, 23 of them CLIP's, and 32
     fused backward launches a step);
 14. (run after phase 13, on phase 9's int4 base and int8 head and phase
     12's int8 CLIP tree) LLaVA (VT), ``vt_7b_int4a8f_qh_qenc_sq8plse``
     with CLIP's attention through kernel 1 at head_dim 64: (a) the VT
     benchmark eval on 8 MMBench items (a TSV of base64 PNGs from a seed,
     read with pandas and PIL) and a 32000-piece SentencePiece tokenizer
     serialized by hand: kernels 1 and 5 at its prefill shape against
     their plain versions, the prefill logits under phase 4's rule, the
     CLIP pass, projector, prefill and decode timed, then
     ``run_inference`` -> ``build_eval_batch`` -> ``llava.generate`` (32
     new tokens: 32 + 23 flash forward and 224 fused MokA launches) -> the
     JSONL -> ``score_option_file``; (b) the micro-batch HTTP front with
     an image request and a text one, both answered 200; (c) the VT step
     (b 4 x L 1024, proj_lse, a8_dots "full", save_q8, bf16 dots): the
     2-layer gradient check with the full tower against the plain path and
     fp32 (phase 13's rule), then 2 warm-up and 2 timed steps (55 flash
     forward, 23 of them CLIP's, and 32 fused backward launches a step);
 15. (after phase 14, its trees freed) the training life cycle from
     checkpoint files through the three training CLIs' ``main`` at
     LLaMA-2-7B's full width and depth (``phase15``): (a) free disk
     checked, LLaMA-2-7B (vocab 32011, 4 shards), CLIP ViT-L/14 and BEATs
     written in bf16 from a seed (safetensors where it imports, else
     ``.bin``) and read back through every importer exactly, the int4
     codes of ``import_llama_quantized`` against ``quantize_llama_base`` of
     the source; (b) ``finetune`` on 12 synthetic AVQA samples (cv2 .avi,
     60 s .wav) with the AVT shipping flags (int4 base, int8 head and
     towers, a8 dots full, qkvod_lse, b 4, L 1024, a checkpoint a step):
     3 steps with kernels 1 and 2 a step asserted against the config's
     counts, then a second invocation with one more epoch that resumes
     from step 3 and reaches step 6; (c) the step-2 checkpoint restored
     into a fresh ``TrainState`` and stepped on batch 3: its loss equals
     the uninterrupted step-3 loss (RESUME_TOL); (d) ``train_vt`` on 12
     seeded PNGs with the VT shipping flags (save_q8, proj_lse), 3 steps,
     ``model.safetensors`` read back exactly; (e) ``pretrain --branch
     visual``, 2 steps, no kernel launched, the stage-1 artifacts read
     back exactly; each CLI's wall, import seconds, step median, tokens/s
     and peak memory printed;
 16. (inside phase 15's work directory, before it is removed) inference
     from checkpoint files (``phase16``): ``infer`` with the int4 base,
     int8 head, b 8 and 32 new tokens on the 12 AVQA items, with a bf16
     and an int8 cache (kernels 1 and 5 and the decode kernel asserted a
     generate, each JSONL scored by ``score``, the first batch timed
     again), ``infer --serve --continuous --kv-quant`` in a process of its
     own answering three HTTP requests, ``eval_vt`` on ``train_vt``'s
     ``model.safetensors`` over phase 14's MMBench items with its scores
     written, and the decode step eager against paged on bf16 and int8
     caches of 512-4096 cells (``paged_decode_auto``'s readings, which
     must give its answer: paged faster in most pairings on each cache);
 17. parallelism (``phase17``, after phase 16 with the earlier trees
     freed): (a) phase 6's step with the bf16 base resident (twice: the
     spread) and in pinned host memory through ``host_stream`` (layers
     copied a layer at a time inside the remat region, 2 x 32 layer
     fetches a step): loss and gradients within the spread, the streamed
     peak at least 10 GiB lower, the bytes copied and the GB/s printed;
     then two ranks on the card in gloo groups (CUDA tensors cross their
     sends as host copies): (b) phase 7's long-context step (b 1, L 4096) as the
     flash ring over a ("seq",) mesh of 2 against rank 0's one-process
     flash step (RING_DEEP_TOL), kernels 1, 3 and 4 launched 2 x 2 x 16,
     2 x 32, 2 x 32 times a rank and kernel 2 never, and at 2 layers the
     flash and the dense ring each under phase 6's rule against fp32;
     (c) ``make_train_step`` on meshes 1,2,1 (FSDP: half the base a rank)
     and 2,1,1 at 7B widths and 4 layers, 2 + 1 steps on rows with
     different supervised counts, against one process on the global batch
     (within REMAT_NOISE of two one-process runs' spread), the bytes
     gathered a step printed, and one step of 2,1,1 with the fused
     dropout (kernels 6-7 launched 2 x 7 x 4 and 7 x 4 times a rank,
     drawing the global rows' masks through the key's row map) against
     one process; before the world, kernels 6-7 on a rank's rows of a
     batch and of a sequence split against the whole array's rows;
     (d) ``finetune``
     (tiny preset) with ``--mesh 1,2,1 --host-offload`` on both ranks;
 18. tensor parallelism on the model axis (``phase18``, after phase 17):
     (b) first, kernels 6-7 on column slices of a 7B-width x (o's and
     down's inputs over 2 and 4 ranks) at the key's column view against
     the whole array's launch: masks and dx identical, dA's rows and the
     summed out within DROP_TOL; every case's one process on the global
     batch, twice (the spread); then two worlds on the card in gloo
     groups, the base split by the rule table (each rank's resident bytes
     checked) and each case against its one process: the losses within
     TRAIN_FLOOR, the first step's gradients no further from an fp32
     step than phase 6's rule lets one process be (the distance from one
     process and two one-process runs' spread printed), each rank's
     kernels 1 and 2 launched once a layer a step
     at its H/m query heads: two ranks for (a) phase 6's model at 4 layers
     on 1,1,2, (b) one fused-dropout step on 1,1,2 (kernels 6-7 at a
     column offset on the second rank's o and down), (d) phase 9's int4
     recipe on 1,1,2 (kernels 8-9 replicated) and (e) ``finetune --mesh
     1,1,2 --host-offload`` at the tiny preset; four for (a) on 1,2,2 and
     (c) CodeLlama-34B's widths (64 heads, 8 kv heads: 2 a rank) on 1,1,4;
 19. MokA at any rank from 1 to 64, right after phase 5 on phase 4's
     base (phase 10 empties it), with (d) after phase 16: (a) kernel 5 at
     P19_RANKS (AVT) and P19_VT_RANK (VT), bf16, every projection shape of
     a 7B layer against the plain version and the layer timed; kernels 6-7
     at P19_DROP_MRS on N 4096 and the 7B widths and on phase 3's ragged
     (333, 200) rows with fp32 and bf16 x, phase 3's rules and kernel 7's
     dx equal to the plain version's bit for bit, a layer timed; kernel 5
     also with four modalities (P19_MOKA_M4), on fp32 x (P19_MOKA_F32) and
     at rank 64 past its key chunk; R1-R3 at P19_RANK_DIMS, b 4 L 1024 with 126 question keys and
     a causal case, each timed; (b) phase 4's base serving rank-32 and
     rank-6 AVT trees (``serve_other_rank``: phase 4's logits rule, 224
     launches of kernel 5 a prefill, a ``DecodeEngine`` request), one new
     token at each other rank; (c) the fused step at rank 32 on 8 of the
     32 layers (phases 8's and 11's gradient rules, then 2 + 1 steps with
     the launch counts asserted) and one step at ranks 2, 6 and 64; (d)
     ``infer --lora-r 32`` on phase 15's files with rank-32 adapter files
     the phase writes, kernel 5 launched on every prefill; the phase
     prints its wall and fails past P19_LIMIT_S (120 s);
 20. MokA past rank 64, right after phase 19's (a)-(c), with (d) in
     phase 17's world: (a) kernel 5 at P20_RANKS (AVT) and P20_VT_RANK
     (VT) through the wide path, with four modalities and on fp32 x,
     kernels 6-7 at P20_DROP_MRS (dx bit for bit, N 4096 and the ragged
     rows), R1-R3 at P20_RANK_DIMS, each against its plain version and
     timed (kernel 5 beside its bound, R1 beside SDPA), then kernel 5's
     wide path launched as each MOKA_WIDE_MUTANTS fault and R1 past
     head_dim 64 as each RANK_WIDE_MUTANTS fault, which must fail those
     checks (``p20_wide_mutants``); (b) phase 4's base serving a rank-128
     tree under phase 4's
     logits rule (``moka_launches``: 224 down and 224 up products and 448
     R1 launches a prefill); (c) the fused step at P20_STEP; (d) kernel 5
     under a ring of 2 ranks at 2 layers, held to one process
     (P20_RING_TOL), with ``keys_kept_home``'s fault required to fail;
     the phase fails past P20_LIMIT_S (90 s);
 21. one JSON line with every kernel's numbers (phases 19-20's instances
     with their launches on those phases' paths, null where no step runs
     them), then the card's line.
fp32 matmuls and convolutions run in full fp32 (TF32 off).  The script
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import shutil
import struct
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
IMUL_RATE = 16.7e12  # 32-bit integer multiplies a second: 64 a clock on each
                 # of 132 SMs at 1.98 GHz (CUDA guide, compute capability
                 # 9.0: half the FMA rate)
PHILOX: dict = {}  # one Philox4x32-10 call (four words) as fused_dropout.cu
                 # compiles it: SASS instructions and 32-bit multiplies
                 # (profile_port.philox_sass, phase 2)
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


_T0 = time.perf_counter()


def log(*a):
    """Print; a phase's header line (``[N] ...``) also gets the seconds
    since the script started."""
    if a and isinstance(a[0], str) and re.match(r"\[\d+\] ", a[0]):
        a = (*a, f"(at {time.perf_counter() - _T0:.1f} s)")
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


def to_card(batch: dict) -> dict:
    """A batch of numpy arrays as tensors on the card."""
    import torch
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def _wrappers() -> dict:
    """Every kernel wrapper by kernel name."""
    from moka_tpu_torch.ops import fbd
    from moka_tpu_torch.ops import flash_attention as fa
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops import fused_dropout as fd
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
    from moka_tpu_torch.ops.paged_decode import paged_decode_attention
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
            "flash_rank_bwd_dkv": fa.flash_rank_bwd_dkv,
            "paged_decode": paged_decode_attention}


MOKA_MORE_COUNTS = {"moka_delta_keys": "keys_launches",
                    "moka_delta_wide_down": "wide_down_launches",
                    "moka_delta_wide_up": "wide_up_launches"}


def _counts() -> dict:
    """Launches by kernel name, ``flash_fwd_hd64``: those of the flash
    forward at head_dim 64 (the CLIP tower), which ``flash_fwd`` counts
    too, ``paged_decode_int8``: the decode kernel's on an int8 cache,
    which ``paged_decode`` counts too, and kernel 5's other launches
    (MOKA_MORE_COUNTS: the key pass alone under a ring, the wide path's
    down and up products past rank 64), which ``moka_delta_fwd`` does not
    count."""
    from moka_tpu_torch.ops.flash_attention import flash_fwd
    from moka_tpu_torch.ops.moka_pallas import moka_delta_fused
    from moka_tpu_torch.ops.paged_decode import paged_decode_attention
    out = {name: fn.launches for name, fn in _wrappers().items()}
    out["flash_fwd_hd64"] = flash_fwd.launches_by_head_dim.get(64, 0)
    out["paged_decode_int8"] = paged_decode_attention.int8_launches
    for name, attr in MOKA_MORE_COUNTS.items():
        out[name] = getattr(moka_delta_fused, attr)
    return out


def _zero_counts() -> None:
    from moka_tpu_torch.ops import fused_dropout as fd
    from moka_tpu_torch.ops.flash_attention import flash_bwd_fused, flash_fwd
    from moka_tpu_torch.ops.paged_decode import paged_decode_attention
    for fn in _wrappers().values():
        fn.launches = 0
    flash_fwd.launches_by_head_dim.clear()
    flash_fwd.launches_by_heads.clear()
    flash_bwd_fused.launches_by_heads.clear()
    fd.dropout_a_fwd.offset_launches = fd.dropout_a_bwd.offset_launches = 0
    paged_decode_attention.int8_launches = 0
    moka = _wrappers()["moka_delta_fwd"]
    for attr in MOKA_MORE_COUNTS.values():
        setattr(moka, attr, 0)


def _launches(**nonzero) -> dict:
    """The launch counts of a path: ``nonzero`` kernels, every other 0."""
    return {name: nonzero.get(name, 0) for name in
            (*_wrappers(), "flash_fwd_hd64", "paged_decode_int8",
             *MOKA_MORE_COUNTS)}


# ------------------------------------------------------------------ phase 2

SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "UBLKRED", "UTMAREDG", "HMMA")
FLASH_SASS = {"flash_fwd": ("flash_fwd_kernel", 2),  # library: function
              "flash_bwd": ("flash_bwd_dq_kernel", 1),  # stem, instances
              "flash_bwd_kv": ("flash_bwd_kv_kernel", 2)}


ATOMICS = r"\b(?:ATOM[A-Z]*|RED(?!UX)[A-Z]*)\b"  # ATOM, ATOMG, ATOMS, RED,
# ...: atomics and reductions to memory (REDUX, a warp's reduction, is not)


_SASS: dict = {}  # library name: its ``cuobjdump -sass`` text


def sass_prefetch(names) -> None:
    """``cuobjdump -sass`` of each library in ``names``, all at once (the
    SASS checks then read them from ``_SASS``)."""
    from moka_tpu_torch import kernels
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    procs = {n: subprocess.Popen([str(tool), "-sass",
                                  str(kernels._target(n))],
                                 stdout=subprocess.PIPE, text=True)
             for n in names}
    for n, proc in procs.items():
        _SASS[n] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"cuobjdump failed on {n}")


def sass_counts(name: str) -> dict:
    """Instruction counts by kernel function in library ``name``'s SASS
    (``cuobjdump -sass``): wgmma (HGMMA), TMA loads and stores (UTMALDG,
    UTMASTG), bulk and tensor reductions (UBLKRED, UTMAREDG), mma.sync
    (HMMA), atomics (ATOM: ``ATOMICS``) and int-to-float conversions
    (I2F: I2F and I2FP)."""
    import re
    if name not in _SASS:
        sass_prefetch([name])
    ops = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    counts = {}
    for block in re.split(r"\n\s*Function : ", "\n" + _SASS[name])[1:]:
        fn, _, body = block.partition("\n")
        c = counts[fn.split()[0]] = dict.fromkeys((*SASS_OPS, "ATOM", "I2F"),
                                                  0)
        for op in ops.findall(body):
            c[op] += 1
        c["ATOM"] = len(re.findall(ATOMICS, body))
        c["I2F"] = len(re.findall(r"\bI2FP?\b", body))
    return counts


CE_SASS = {"fused_ce": "fused_ce_fwd_kernel",      # kernels 8 and 9:
           "fused_ce_bwd": "fused_ce_bwd_kernel"}  # library: function stem
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"  # ptxas


def check_ce_sass() -> dict:
    """Kernels 8 and 9 run on wgmma and TMA: each one's kernel function
    shows HGMMA and UTMALDG and no HMMA, kernel 9's also a bulk reduction
    (UBLKRED or UTMAREDG, dx); kernel 8's merge launch (SIMT) is only
    printed.  ptxas must not have serialized kernel 8's wgmmas (its
    C7510-C7520 warnings).  Raises otherwise."""
    from moka_tpu_torch import kernels
    out = {}
    for lib, stem in CE_SASS.items():
        out[lib] = sass_counts(lib)
        for fn, c in out[lib].items():
            log(f"    {lib} SASS {fn}: " +
                ", ".join(f"{op} {k}" for op, k in c.items()))
        ks = [c for fn, c in out[lib].items() if stem in fn]
        if len(ks) != 1 or ks[0]["HGMMA"] == 0 or ks[0]["UTMALDG"] == 0 or \
                ks[0]["HMMA"] or (lib == "fused_ce_bwd" and
                                  ks[0]["UBLKRED"] + ks[0]["UTMAREDG"] == 0):
            raise AssertionError(f"{lib} SASS: {stem} lacks wgmma, TMA or "
                                 f"(kernel 9) its bulk reduction, or keeps "
                                 f"mma.sync: {out[lib]}")
    text = kernels.log_path("fused_ce")
    if not text.exists():
        raise AssertionError(f"no ptxas report for kernel 8's library: {text}")
    if WGMMA_SERIALIZED in text.read_text():
        raise AssertionError(f"ptxas serialized kernel 8's wgmmas: see {text}")
    return out


DECODE_SASS = ("paged_decode", "paged_decode_kernel", 2)  # library,
# function stem, instances (bf16 and int8 cache)


def check_decode_sass() -> dict:
    """The decode kernel loads k and v by TMA and takes both products on
    mma.sync: each instance (bf16 and int8 cache) shows UTMALDG and HMMA;
    and the int8 instance converts no more ints to floats (I2F, I2FP)
    than the bf16 one, whose few are the seeds of its integer divisions:
    its codes are widened by LOP3 and HFMA2.  Raises otherwise."""
    lib, stem, n = DECODE_SASS
    out = sass_counts(lib)
    for fn, c in out.items():
        log(f"    {lib} SASS {fn}: " +
            ", ".join(f"{op} {k}" for op, k in c.items()))
    ks = {fn: c for fn, c in out.items() if stem in fn}
    int8 = [c for fn, c in ks.items() if "ILb1E" in fn]
    bf16 = [c for fn, c in ks.items() if "ILb0E" in fn]
    if len(ks) != n or len(int8) != 1 or len(bf16) != 1 or any(
            c["UTMALDG"] == 0 or c["HMMA"] == 0 for c in ks.values()) or \
            int8[0]["I2F"] > bf16[0]["I2F"]:
        raise AssertionError(f"{lib} SASS: an instance lacks TMA loads or "
                             f"mma.sync, or the int8 one converts its "
                             f"codes: {out}")
    return out


BD_SASS = ("block_diag", "block_diag_kernel", 4)  # kernel 10: library,
                                                 # function stem, instances


RANK_BWD_SASS = (("flash_rank_dq_kernel", "flash_rank_dkv_kernel"), 5)
# the rank backward (fp32 SIMT): function stems, instances each (hd 4, 8,
# 16, 32, 64)
RANK_WIDE_SASS = {"flash_rank_fwd_wide": 3, "flash_rank_dq_wide": 1,
                  "flash_rank_dkv_wide": 1}  # past head_dim 64: instances
# (the forward's at 32, 16 and 8 query rows a CTA)


def check_bd_rank_sass() -> dict:
    """Kernel 10 loads x by TMA: each of its four instances (bf16 and fp32
    x, b 8 and any b) shows UTMALDG; the rank backward sums in a fixed
    order: each instance of its dq and dk/dv kernels shows no atomic (ATOM,
    RED), so repeats are bit-identical, and so does each instance of the
    three kernels past head_dim 64 (``RANK_WIDE_SASS``).  Raises
    otherwise."""
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
    stems, n = RANK_BWD_SASS
    for stem, want in [(st, n) for st in stems] + \
            list(RANK_WIDE_SASS.items()):
        ks = [c for fn, c in out["flash_rank"].items() if stem in fn]
        if len(ks) != want or any(c["ATOM"] for c in ks):
            raise AssertionError(f"flash_rank SASS: {stem} has {len(ks)} "
                                 f"instances, want {want}, or an "
                                 f"atomic: "
                                 f"{out['flash_rank']}")
    return out


MOKA_SASS = ("moka_delta_fwd", "moka_delta_kernelILi", 20)  # kernel 5:
# library, the bf16 kernel's mangled stem, instances (R 4/8/16/32/64 x M
# 1-4)
MOKA_WIDE_SASS = {"gemm_kernel": 2, "moka_wide_kernel": 2}  # its wide
# path's products: bf16 x down / up on wgmma and TMA; fp32 x down / up,
# fp32 SIMT


def check_moka_sass() -> dict:
    """Kernel 5's bf16 path runs its products on wgmma and moves x and the
    delta by TMA: each of its twenty instances shows HGMMA, UTMALDG and
    UTMASTG and no HMMA; the wide path's bf16-x products (``gemm_kernel``,
    down and up) show HGMMA and UTMALDG and no HMMA, the up product also
    UTMASTG (the delta stored by TMA), its fp32-x products
    (``moka_wide_kernel``, fp32 FMAs) are there, and none of the four has
    an atomic; the key pass, the operand passes and the fp32 path (SIMT)
    are only printed.  Raises otherwise."""
    out = sass_counts(MOKA_SASS[0])
    for fn, c in out.items():
        log(f"    {MOKA_SASS[0]} SASS {fn}: " +
            ", ".join(f"{op} {k}" for op, k in c.items()))
    ks = [c for fn, c in out.items() if MOKA_SASS[1] in fn]
    if len(ks) != MOKA_SASS[2] or any(
            c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["UTMASTG"] == 0 or
            c["HMMA"] for c in ks):
        raise AssertionError(f"moka_delta_fwd SASS: an instance of the bf16 "
                             f"kernel lacks wgmma or TMA: {out}")
    gemm = {fn: c for fn, c in out.items() if "gemm_kernel" in fn}
    simt = [c for fn, c in out.items() if "moka_wide_kernel" in fn]
    if len(gemm) != MOKA_WIDE_SASS["gemm_kernel"] or \
            len(simt) != MOKA_WIDE_SASS["moka_wide_kernel"] or any(
                c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] or
                ("ILb1E" in fn and c["UTMASTG"] == 0)
                for fn, c in gemm.items()) or \
            any(c["ATOM"] for c in [*gemm.values(), *simt]):
        raise AssertionError(f"moka_delta_fwd SASS: the wide path's bf16 "
                             f"products lack wgmma or TMA, keep mma.sync, "
                             f"or a product kernel is missing or has an "
                             f"atomic: {out}")
    return out


DROP_SASS = ("fused_dropout", {"dropout_fwd_kernel": (4, False),
                                 "dropout_bwd_kernel": (4, True)})
# kernels 6-7: library, {bf16-x kernel's stem: (instances (A bf16, fp32 x
# the generator, forced words), TMA stores required)}
DROP_DX_SASS = ("dropout_dx_kernel", 8)  # dx past M*r 64: x and A bf16 /
# fp32 x the generator / forced words, fp32 SIMT


def check_dropout_sass() -> dict:
    """Kernels 6-7's bf16-x path runs its products on wgmma (the backward
    its dA; dx is an fp32 FMA chain) and moves x by TMA: each instance of
    the forward and of the backward (A bf16 and fp32, the generator and
    forced words) shows HGMMA and
    UTMALDG and no HMMA, the backward's also UTMASTG (dx); the dx kernel
    past M*r 64 (``DROP_DX_SASS``, its chunks of A's rows) has its eight
    instances and no atomic (dx bit for bit); the fp32-x kernels (SIMT)
    are only printed.  Raises otherwise."""
    lib, stems = DROP_SASS
    out = sass_counts(lib)
    for fn, c in out.items():
        log(f"    {lib} SASS {fn}: " +
            ", ".join(f"{op} {k}" for op, k in c.items()))
    for stem, (n, stores) in stems.items():
        ks = [c for fn, c in out.items() if stem in fn]
        if len(ks) != n or any(
                c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] or
                (stores and c["UTMASTG"] == 0) for c in ks):
            raise AssertionError(f"{lib} SASS: an instance of {stem} lacks "
                                 f"wgmma or TMA, or keeps mma.sync: {out}")
    ks = [c for fn, c in out.items() if DROP_DX_SASS[0] in fn]
    if len(ks) != DROP_DX_SASS[1] or any(c["ATOM"] for c in ks):
        raise AssertionError(f"{lib} SASS: {DROP_DX_SASS[0]} has {len(ks)} "
                             f"instances, want {DROP_DX_SASS[1]}, or an "
                             f"atomic: {out}")
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
        ("o[g * W + d] = vsum[d] / static_cast<float>(S);",
         "o[g * W + d] = 0.f;")],
    "the wide forward walks only its first key tile": [
        ("  const int tiles = kend < lo ? 0 : (kend - lo) / WKT + 1;",
         "  const int tiles = kend < lo ? 0 : 1;")]}
RANK_WIDE_MUTANTS = ("the wide forward walks only its first key tile",)
# (faults of R1 past head_dim 64: phase 20 runs them, phase 3 the others)
RANK_BWD_MUTANTS = {  # flash_rank.cu's dq (R2) and dk/dv (R3)
    "dq walks only the first 32 keys of the span": [
        ("  const int stop = causal ? min(last, row + q_offset) : last;",
         "  const int stop = min(causal ? min(last, row + q_offset) : last,\n"
         "                       first + 31);")],
    "dk/dv sums only the first query chunk": [
        ("for (int i0 = q_from / CHUNK * CHUNK; i0 < L; i0 += CHUNK) {",
         "for (int i0 = q_from / CHUNK * CHUNK;\n"
         "         i0 < min(L, q_from / CHUNK * CHUNK + CHUNK); i0 += CHUNK) {")],
    "dk/dv gives a block's first visible key zeros, as if no query saw it": [
        ("        if (j <= reach)\n", "        if (j <= reach && u > 0)\n")],
    "dk/dv walks only each work CTA's first key block": [
        ("       key0 += work * BWD_KEYS) {", "       key0 += S) {")],
    "dk/dv adds only the first warp's queries": [
        ("for (int w = 0; w < WARPS; ++w) sum += part[w][kt][e];",
         "for (int w = 0; w < 1; ++w) sum += part[w][kt][e];")]}
BD_MUTANTS = {  # block_diag.cu
    "reads the block transposed": [
        ("w[i8][j] = __ldg(bp + i8 * 8 + j);",
         "w[i8][j] = __ldg(bp + j * 8 + i8);")]}
MOKA_MUTANTS = {  # moka_delta_fwd.cu's bf16 kernels (the main path's)
    "drops the attention term": [
        ("        if (add) buf[at * R + r] += w * (a.attn_weight * (o / l));",
         "        (void)o;")],
    "walks only the first key chunk": [
        ("      for (int c0 = 0; c0 < n_q; c0 += C::KCAP) {",
         "      for (int c0 = 0; c0 < min(n_q, C::KCAP); c0 += C::KCAP) {")],
    "the wide down product skips its last d_in tile": [
        ("  const int nkb = UP ? 3 * (w.rp / 64) : (w.d_in + 63) / 64;",
         "  const int nkb = UP ? 3 * (w.rp / 64) : (w.d_in + 63) / 64 - 1;")],
    "the wide up product drops the attention term": [
        ("      v = make_float2(v.x + mk * (w.attn_weight * u.x),\n"
         "                      v.y + mk * (w.attn_weight * u.y));",
         "      (void)mk;\n      (void)u;")]}
MOKA_WIDE_MUTANTS = ("the wide down product skips its last d_in tile",
                     "the wide up product drops the attention term")
# (faults of kernel 5's wide path, past rank 64: phase 20 runs them)
DROP_MUTANTS = {  # fused_dropout.cu's bf16-x kernels (the path's)
    "the backward masks with the neighbouring counter (col // 4 + 1)": [
        ("        words8<FORCED>(bits, n0 + r, c0 + 8 * q, sh.n_rows, sh.d, "
         "sh.key, w);",
         "        words8<FORCED>(bits, n0 + r, c0 + 8 * q + 4, sh.n_rows, sh.d, "
         "sh.key, w);")],
    "dA sums only the first half of the rows": [
        ("            from_float((dacc[k] + other[k * 128 + t]) * "
         "sh.inv_keep,", "            from_float(dacc[k] * sh.inv_keep,")],
    "the forward ignores the keep mask": [
        ("      keep_masks(w, sh.thresh, fk);",
         "      fk[0] = fk[1] = fk[2] = fk[3] = 0xffffffffu;")]}
CE_FWD_MUTANTS = {  # fused_ce.cu (kernel 8)
    "compares the target at its position, not its vocab column": [
        ("          const int want = swap_low_bits(tp) - 2 * t;",
         "          const int want = tp - 2 * t;")],
    "leaves the first span's partial out of the merge": [
        ("  for (int c = 0; c < n_spans; ++c) {\n",
         "  for (int c = 1; c < n_spans; ++c) {\n")],
    "widens only the first half of each multicast head tile": [
        ("  for (int u0 = 0; u0 < UNITS_EACH; u0 += CONVERT_UNROLL) {",
         "  for (int u0 = 0; u0 < UNITS_EACH / 2; u0 += CONVERT_UNROLL) {")],
    "drops the phantom-column mask": [
        ("      if (v_sub + TV > a.v_real)\n", "      if (false)\n")]}
DECODE_MUTANTS = {  # paged_decode.cu
    "drops the value scales vs": [
        ("        p[i] = vis[i] ? p[i] * st->vs[key] : 0.f;",
         "        p[i] = vis[i] ? p[i] : 0.f;")],
    "leaves the last span out of the merge": [
        ("    for (int s = 0; s < a.n_span; ++s) {",
         "    for (int s = 0; s < a.n_span - 1; ++s) {")],
    "the producer never loads a span's last tile": [
        ("    if (t < t_hi) {", "    if (t < t_hi - 1) {")]}
DECODE_MERGE_MUTANTS = ("leaves the last span out of the merge",)  # faults
# that show only where a pair's keys split into several spans (not on the
# 7B serving path: one span a pair there)
MUTANT_SOURCES = {"flash_rank": ("flash_rank.cu",
                                  {**RANK_MUTANTS, **RANK_BWD_MUTANTS}),
                  "block_diag": ("block_diag.cu", BD_MUTANTS),
                  "moka_delta_fwd": ("moka_delta_fwd.cu", MOKA_MUTANTS),
                  "fused_dropout": ("fused_dropout.cu", DROP_MUTANTS),
                  "fused_ce": ("fused_ce.cu", CE_FWD_MUTANTS),
                  "paged_decode": ("paged_decode.cu", DECODE_MUTANTS)}
MUTANTS: dict = {}  # library name: {fault: loaded library}, after phase 2


@contextlib.contextmanager
def swapped_library(name, lib):
    """Within: the wrappers of library ``name`` launch ``lib``, an edited
    copy of its source."""
    from moka_tpu_torch.ops import fbd
    from moka_tpu_torch.ops import flash_attention as fa
    from moka_tpu_torch.ops import fused_ce as fc
    from moka_tpu_torch.ops import fused_dropout as fd
    from moka_tpu_torch.ops import moka_pallas as mp
    from moka_tpu_torch.ops import paged_decode as pd
    own = {"block_diag": fbd, "moka_delta_fwd": mp, "fused_dropout": fd,
           "paged_decode": pd}
    by_name = fc if name.startswith("fused_ce") else fa  # _libs by name
    if name in own:
        kept = own[name]._library()
        own[name]._lib = own[name].bind(lib)
    else:
        kept = by_name._library(name)
        by_name._libs[name] = by_name.bind(name, lib)
    try:
        yield
    finally:
        if name in own:
            own[name]._lib = kept
        else:
            by_name._libs[name] = kept


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


MOKA_RANKS = (4, 8, 16)  # phase 3's ranks of kernel 5 (phase 19: the rest)


def moka_inputs(b, L, d_in, d_out, flavour, dtype, seed, rank=4,
                qspans=None, no_question_row=False):
    """Random x (N(0, 1) in ``dtype``), Kaiming-uniform fp32 A and B ~ N(0,
    0.02^2) at ``rank`` with ``avt_masks``'s layout; ``qspans``: the
    question spans instead of [2, 130); ``no_question_row``: the last row
    has no question token."""
    import torch
    from moka_tpu_torch.ops.moka import MokaSpec
    g = torch.Generator(device="cuda").manual_seed(seed)
    spec = (MokaSpec.avt(rank=rank, dropout_rate=0.0) if flavour == "avt"
            else MokaSpec.vt(rank=rank, dropout_rate=0.0))
    M = spec.num_modalities
    x = torch.randn((b, L, d_in), generator=g, device="cuda").to(dtype)
    bound = 1.0 / math.sqrt(d_in)
    a = torch.rand((M, d_in, rank), generator=g, device="cuda") * 2 * bound \
        - bound
    bm = torch.randn((rank, d_out), generator=g, device="cuda") * 0.02
    mod, qm = avt_masks(b, L, M)
    if qspans is not None:
        qm.zero_()
        for lo, hi in qspans:
            qm[:, lo:hi] = 1
    if no_question_row:
        qm[-1] = 0
    return x, a, bm, mod, qm, spec


def check_moka(what, x, a, bm, mod, qm, spec) -> float:
    """Kernel 5 against its plain version under MOKA_TOL (of max|plain|,
    in x's type); max|err|.  Raises AssertionError past the limit."""
    import torch
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    got = moka_delta_fused(x, a, bm, mod, qm, spec)
    torch.cuda.synchronize()
    ref = moka_delta_fused_plain(x, a, bm, mod, qm, spec)
    scale = float(ref.float().abs().max())
    d = float((got.float() - ref.float()).abs().max())
    tol = MOKA_TOL[str(x.dtype).split(".")[1]]
    log(f"  moka {what}: max|err| {d:.3e}, max|plain| {scale:.3e}, rel "
        f"{d / scale:.3e} (tol {tol})")
    if not d <= tol * scale:
        raise AssertionError(f"fused MokA kernel disagrees with its plain "
                             f"version: {what}")
    return d


def mm_prefill_checks(records, new_tokens=32) -> None:
    """Kernels 1 and 5 at the exact prefill shape of phase 12's batch
    (``mm_batch(mm_config(), 8)``: its length, its own left pads, its
    modality and question masks), on random q/k/v, x, A and B, against
    their plain versions under phase 3's limits, kernel 5 at every rank
    it takes; the records' max_abs_err take the larger error."""
    import torch
    import torch.nn.functional as F
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
    for rank in MOKA_RANKS:
        rspec = dataclasses.replace(spec, rank=rank)
        for d_in, d_out in sorted({(cfg.dim, cfg.dim),
                                   (cfg.dim, cfg.intermediate),
                                   (cfg.intermediate, cfg.dim)}):
            x = torch.randn((b, L, d_in), generator=g,
                            device="cuda").bfloat16()
            bound = 1.0 / math.sqrt(d_in)
            a = torch.rand((3, d_in, rank), generator=g,
                           device="cuda") * 2 * bound - bound
            bm = torch.randn((rank, d_out), generator=g,
                             device="cuda") * 0.02
            d = check_moka(f"multimodal prefill r{rank} bf16 "
                           f"{d_in}->{d_out}", x, a, bm, mod, qm, rspec)
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


MOKA_SPLIT_Q = ((2, 40), (70, 71), (100, 164))  # a question mask with gaps
MOKA_KCAP = {4: 1024, 8: 512, 16: 256}  # keys kernel 5 stages at once


def moka_record(b, L, dim, inter) -> dict:
    """Kernel 5 against its plain version (``check_moka``) at the serving
    prefill (b, L) for each distinct projection shape at ranks 4, 8 and
    16, AVT and VT, bf16 and fp32 x; then at each rank with a question
    mask that is not contiguous and a row with no question token, and with
    more question keys than one shared-memory stage holds (MOKA_KCAP);
    launched as each MOKA_MUTANTS fault it must fail.  Timed at each rank
    over the seven projections of a layer (AVT, bf16): the kernel alone
    (a CUDA graph of launches; x, 59-158 MB, overflows the L2) and the
    wrapper back to back; at rank 4 also the plain version."""
    import torch
    from moka_tpu_torch.ops.moka_pallas import (moka_delta_fused,
                                                moka_delta_fused_plain)
    from profile_port import graph_ms
    shapes = {"q": (dim, dim), "k": (dim, dim), "v": (dim, dim),
              "o": (dim, dim), "gate": (dim, inter), "up": (dim, inter),
              "down": (inter, dim)}
    err = 0.0
    for i, (d_in, d_out) in enumerate(sorted(set(shapes.values()))):
        for rank in MOKA_RANKS:
            for flavour in ("avt", "vt"):
                for dtype in (torch.bfloat16, torch.float32):
                    args = moka_inputs(b, L, d_in, d_out, flavour, dtype,
                                       10 + i, rank)
                    d = check_moka(f"{flavour} r{rank} {str(dtype)[6:]} "
                                   f"{d_in}->{d_out}", *args)
                    if dtype == torch.bfloat16:
                        err = max(err, d)
    for rank in MOKA_RANKS:
        for flavour, dtype in (("avt", torch.bfloat16),
                               ("avt", torch.float32),
                               ("vt", torch.bfloat16)):
            d = check_moka(
                f"{flavour} r{rank} {str(dtype)[6:]} question spans "
                f"{MOKA_SPLIT_Q}, last row none",
                *moka_inputs(4, L, dim, dim, flavour, dtype, 30 + rank,
                             rank, MOKA_SPLIT_Q, no_question_row=True))
            if dtype == torch.bfloat16:
                err = max(err, d)
        n_q = MOKA_KCAP[rank] + 44
        for dtype in (torch.bfloat16, torch.float32):
            d = check_moka(
                f"avt r{rank} {str(dtype)[6:]} {n_q} question keys",
                *moka_inputs(2, 2 * n_q + 64, dim, dim, "avt", dtype,
                             40 + rank, rank, ((1, 1 + n_q),)))
            if dtype == torch.bfloat16:
                err = max(err, d)
    for what, lib in MUTANTS["moka_delta_fwd"].items():
        if what in MOKA_WIDE_MUTANTS:
            continue  # phase 20's
        with swapped_library("moka_delta_fwd", lib):
            must_fail(f"kernel 5 mutant ({what})", lambda: check_moka(
                f"mutant ({what}) r16 bf16 {MOKA_KCAP[16] + 44} question "
                f"keys", *moka_inputs(2, 2 * MOKA_KCAP[16] + 152, dim, dim,
                                      "avt", torch.bfloat16, 56, 16,
                                      ((1, MOKA_KCAP[16] + 45),))))
    by_rank = {}
    plain_ms = 0.0
    for rank in MOKA_RANKS:
        t = {"ms": 0.0, "back_to_back_ms": 0.0, "bound_ms": 0.0}
        n_bytes = n_ops = 0.0
        for name, (d_in, d_out) in shapes.items():
            x, a, bm, mod, qm, spec = moka_inputs(
                b, L, d_in, d_out, "avt", torch.bfloat16, 20, rank)

            def call():
                moka_delta_fused(x, a, bm, mod, qm, spec)

            one = {"ms": graph_ms(call, n=20),
                   "back_to_back_ms": time_ms(call)}
            if rank == 4:
                plain_ms += time_ms(lambda: moka_delta_fused_plain(
                    x, a, bm, mod, qm, spec))
            nb = nbytes(x, a, bm, mod, qm) + b * L * d_out * x.element_size()
            nq = float(qm.sum(dim=-1).max())
            # the products as the kernel issues them on the tensor cores
            # (A and B split into bf16 halves: 2*M*r columns down, 3r deep
            # up), the attention in fp32: 2 attention streams x n_q keys
            tc = 2.0 * b * L * (d_in * 2 * 3 * rank + d_out * 3 * rank)
            fp = 2.0 * b * L * nq * 2 * 2 * rank
            one["bound_ms"], _ = bound_ms(nb, tc, BF16_FLOPS,
                                          (fp, FP32_FLOPS))
            log(f"  moka timing r{rank} {name} {d_in}->{d_out} (b {b}, L "
                f"{L}, bf16, AVT): kernel alone {one['ms']:.4f} ms, back to "
                f"back {one['back_to_back_ms']:.4f} ms, bound "
                f"{one['bound_ms']:.4f} ms")
            for k in t:
                t[k] += one[k]
            n_bytes += nb
            n_ops = max(n_ops, tc / BF16_FLOPS + fp / FP32_FLOPS)
            del x
        t["bound_by"] = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops \
            else "operations"
        by_rank[rank] = t
        log(f"  moka r{rank}, a layer: kernel alone {t['ms']:.4f} ms, back "
            f"to back {t['back_to_back_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {"name": "moka_delta_fwd", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/moka_delta_fwd.cu",
            "replaces": "moka_tpu/ops/moka_pallas.py:35",
            "launches": None, "max_abs_err": err,
            "tolerance": MOKA_TOL["bfloat16"], "ms": by_rank[4]["ms"],
            "back_to_back_ms": by_rank[4]["back_to_back_ms"],
            "plain_ms": plain_ms, "bound_ms": by_rank[4]["bound_ms"],
            "bound_by": by_rank[4]["bound_by"], "library_ms": None,
            "by_rank": by_rank,
            "shape": f"b {b} L {L} bf16 AVT r4, one layer: the seven "
                     f"projections summed, the kernel alone in a CUDA "
                     f"graph (by_rank: r4, r8, r16)"}


DROP_RATE = 0.05   # the training path's LoRA dropout
DROP_MRS = (4, 8, 12, 16, 24, 32, 48, 64)  # M * r of ranks 4, 8, 16 x 1-4
                   # modalities, phase 3's (phase 19: up to 256)
DROP_TIMED = {4: 12, 8: 24, 16: 48}  # rank: M * r of AVT, timed a layer


def dropout_case(n, d, x_dtype, a_dtype, forced, seed, mr=12):
    """Inputs of the fused-dropout kernels: random x (n, d), A (d, mr)
    kaiming-uniform, a cotangent g (n, mr) fp32, a key, and (forced mode)
    random 32-bit words."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=g, device="cuda").to(x_dtype)
    bound = 1.0 / math.sqrt(d)
    a = (torch.rand((d, mr), generator=g, device="cuda") * 2 - 1) * bound
    gout = torch.randn((n, mr), generator=g, device="cuda")
    bits = torch.randint(0, 1 << 32, (n, d), generator=g, device="cuda",
                         dtype=torch.int64) if forced else None
    return x, a.to(a_dtype), gout, DropoutKey(1000 + seed), bits


def check_dropout(name, x, a, gout, key, bits, exact_dx=False) -> float:
    """Kernels 6 and 7 against ``dropout_a_fwd_plain`` /
    ``dropout_a_bwd_plain`` on the same words: out and dA within DROP_TOL
    (fp32 sums in another order; a bf16 dA within one bf16 ulp), dx within
    one bf16 ulp and bit-identical on all but DROP_DX_MISMATCH of its
    elements, dx's zeros exactly the plain mask, two calls bit-identical,
    the forward's mask the backward's (the kernel's out equals the plain
    forward over dx's non-zero pattern), the keep share within 5 sigma;
    ``exact_dx``: dx equal to the plain version's bit for bit (its FMA
    chain in the plain version's order)."""
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
          and ulp <= 0 and mism <= (0 if exact_dx else DROP_DX_MISMATCH)
          and da_ok
          and abs(share - (1 - DROP_RATE)) <= 5 * sigma)
    log(f"  dropout {name}: x {tuple(x.shape)} {str(x.dtype)[6:]}, A "
        f"{tuple(a.shape)} {str(a.dtype)[6:]}, "
        f"{'forced bits' if bits is not None else 'Philox'}"
        f": out rel err {e_out:.2e}, vs own-mask forward {e_own:.2e} (tol "
        f"{DROP_TOL}); dx beyond one ulp {ulp:.2e}, not bit-identical "
        f"{mism:.2e} (tol {0 if exact_dx else DROP_DX_MISMATCH}); dA err "
        f"{e_da:.2e}; zeros = "
        f"plain mask {pattern}; repeat bit-identical {same}; keep share "
        f"{share:.6f} ({(share - 1 + DROP_RATE) / sigma:+.2f} sigma)")
    if not ok:
        raise AssertionError(f"fused dropout kernels disagree with their "
                             f"plain versions ({name})")
    return float((out - ref).abs().max())


def dropout_check_cases(n, dim, inter) -> list[tuple]:
    """(rows, d, x dtype, A dtype, forced, M*r): every M*r of DROP_MRS at
    the training path's (N, dim) and (N, inter) with bf16 x, fp32 and bf16
    A, Philox and forced words, and at a ragged (333, 200) with fp32 x
    (fp32 A, Philox) and bf16 x (bf16 A, forced; the TMA boxes' ragged
    edges)."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    return [case for mr in DROP_MRS for case in (
        *[(n, d, bf, adt, forced, mr) for d in (dim, inter)
          for adt in (f32, bf) for forced in (False, True)],
        (333, 200, f32, f32, False, mr), (333, 200, bf, bf, True, mr))]


def dropout_records(n, dim, inter) -> list[dict]:
    """Check kernels 6-7 at every M*r they take (``dropout_check_cases``);
    launched as each DROP_MUTANTS fault they must fail; then time them over
    one layer's seven projections (x and A bf16, Philox: the path's dtypes)
    at ranks 4, 8 and 16 of AVT (DROP_TIMED), at rank 4 beside the plain
    versions and the library's ``F.dropout(x) @ A`` (forward, and its
    autograd backward alone on one recorded forward).  The bound counts
    the products as the kernels issue them on the tensor cores (M*r padded
    to wgmma's 64 rows forward, and to 16 for dx; g split into two bf16
    halves) and the generator: its SASS instructions a call at LANE_INSTR
    and its 32-bit multiplies at IMUL_RATE (PHILOX, counted in phase 2)."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import fused_dropout as fd
    err = 0.0
    for i, (rows, d, xdt, adt, forced, mr) in enumerate(
            dropout_check_cases(n, dim, inter)):
        args = dropout_case(rows, d, xdt, adt, forced, seed=i, mr=mr)
        err = max(err, check_dropout(f"case {i}", *args))
        del args
    for what, lib in MUTANTS["fused_dropout"].items():
        with swapped_library("fused_dropout", lib):
            must_fail(f"kernels 6-7 mutant ({what})", lambda: check_dropout(
                f"mutant ({what})", *dropout_case(n, dim, torch.bfloat16,
                                                  torch.bfloat16, False,
                                                  seed=90)))
    dims = [dim] * 6 + [inter]  # q, k, v, o, gate, up read dim; down inter
    by_rank = {}
    for rank, mr in DROP_TIMED.items():
        tot = {k: 0.0 for k in ("fwd", "bwd", "fwd_plain", "bwd_plain",
                                "fwd_lib", "bwd_lib", "fwd_bytes",
                                "bwd_bytes", "fwd_flops", "bwd_flops",
                                "philox", "philox_mul")}
        for d in dims:
            x, a, gout, key, _ = dropout_case(n, d, torch.bfloat16,
                                              torch.bfloat16, False, seed=50,
                                              mr=mr)
            tot["fwd"] += time_ms(lambda: fd.dropout_a_fwd(x, a, key,
                                                           DROP_RATE))
            tot["bwd"] += time_ms(lambda: fd.dropout_a_bwd(x, a, gout, key,
                                                           DROP_RATE))
            elems = n * d
            tot["fwd_bytes"] += nbytes(x, a) + n * mr * 4
            tot["bwd_bytes"] += 2 * nbytes(x) + nbytes(a, gout) + nbytes(a)
            kpad = 16 * -(-mr // 16)
            tot["fwd_flops"] += 2 * elems * 64
            tot["bwd_flops"] += 2 * elems * (2 * 64 + 2 * kpad)
            tot["philox"] += elems / 4 * PHILOX["instructions"]
            tot["philox_mul"] += elems / 4 * PHILOX["multiplies"]
            if rank == 4:
                tot["fwd_plain"] += time_ms(lambda: fd.dropout_a_fwd_plain(
                    x, a, key, DROP_RATE), iters=3, warmup=1)
                tot["bwd_plain"] += time_ms(lambda: fd.dropout_a_bwd_plain(
                    x, a, gout, key, DROP_RATE), iters=3, warmup=1)
                xg = x.clone().requires_grad_(True)
                ag = a.clone().requires_grad_(True)
                gb = gout.to(torch.bfloat16)

                def lib():
                    return F.dropout(xg, DROP_RATE) @ ag

                lib_out = lib()

                def lib_bwd():  # the backward alone, on one recorded forward
                    torch.autograd.grad(lib_out, (xg, ag), gb,
                                        retain_graph=True)

                tot["fwd_lib"] += time_ms(lib, iters=30, warmup=3)
                tot["bwd_lib"] += time_ms(lib_bwd, iters=30, warmup=3)
                del xg, ag, gb, lib_out
            del x, a, gout
        for which in ("fwd", "bwd"):
            tot[f"{which}_bound"], tot[f"{which}_bound_by"] = bound_ms(
                tot[f"{which}_bytes"], tot[f"{which}_flops"], BF16_FLOPS,
                (tot["philox"], LANE_INSTR), (tot["philox_mul"], IMUL_RATE))
            log(f"  dropout {which} timing r{rank} (M*r {mr}), one layer's "
                f"seven projections (N {n}, d {dim} x6 + {inter}, bf16 x and "
                f"A): kernel {tot[which]:.4f} ms, bound "
                f"{tot[which + '_bound']:.4f} ms "
                f"({tot[which + '_bound_by']})" + (
                    f", plain {tot[which + '_plain']:.4f} ms, F.dropout + "
                    f"matmul {tot[which + '_lib']:.4f} ms" if rank == 4
                    else ""))
        by_rank[rank] = tot
    records = []
    for which, line, kernel in (("fwd", 55, 6), ("bwd", 70, 7)):
        tot = by_rank[4]
        records.append({
            "name": f"dropout_a_{which}", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/fused_dropout.cu",
            "replaces": f"moka_tpu/ops/fused_dropout.py:{line}",
            "launches": None, "max_abs_err": err,
            "tolerance": f"out, dA {DROP_TOL} of max|plain|; dx one bf16 "
                         f"ulp; masks exact",
            "ms": tot[which], "plain_ms": tot[which + "_plain"],
            "bound_ms": tot[which + "_bound"],
            "bound_by": tot[which + "_bound_by"],
            "library_ms": tot[which + "_lib"],
            "library": "F.dropout(x) @ A_flat in bf16" + (
                "" if which == "fwd" else ", its autograd backward alone"),
            "by_rank": {r: {"mr": DROP_TIMED[r], "ms": t[which],
                            "bound_ms": t[which + "_bound"]}
                        for r, t in by_rank.items()},
            "shape": f"N {n}, d {dim} (6 projections) and {inter} (down), "
                     f"x and A bf16, Philox, AVT r4 (M*r 12): one layer, "
                     f"seven launches (by_rank: r4, r8, r16)"})
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


CE_REPEATS = 50  # more launches of kernel 8 on one input, all alike


def check_ce_fwd(name, x, w, scale, t, repeats=0) -> tuple[float, float]:
    """Kernel 8 against ``fused_ce_fwd_plain`` on the same inputs: nll and
    lse within CE_LSE_TOL, then ``repeats`` more launches whose nll and lse
    must equal the first bit for bit (the kernel sums in a fixed order; a
    race between the cluster's CTAs would show here).  Raises
    AssertionError otherwise; returns (max error, the plain lse)."""
    import torch
    from moka_tpu_torch.ops import fused_ce as fc
    nll, lse = fc.fused_ce_fwd(x, w, scale, t)
    rnll, rlse = fc.fused_ce_fwd_plain(x, w, scale, t)
    e_nll = float((nll - rnll).abs().max())
    e_lse = float((lse - rlse).abs().max())
    differ = sum(not (torch.equal(a, nll) and torch.equal(b, lse))
                 for a, b in (fc.fused_ce_fwd(x, w, scale, t)
                              for _ in range(repeats)))
    log(f"  fused CE fwd {name}: x {tuple(x.shape)}, head "
        f"{tuple(w.shape)}: max|nll err| {e_nll:.3e}, max|lse err| "
        f"{e_lse:.3e} (tol {CE_LSE_TOL})" + (
            f"; {repeats} more launches, {differ} differ from the first"
            if repeats else ""))
    if not (e_nll <= CE_LSE_TOL and e_lse <= CE_LSE_TOL) or differ:
        raise AssertionError(f"kernel 8 disagrees with its plain version "
                             f"or with itself ({name})")
    return max(e_nll, e_lse), rlse


def check_ce(name, x, w, scale, t, cot, fault=False,
             repeats=0) -> tuple[float, float]:
    """Kernels 8 and 9 against ``fused_ce_fwd_plain`` /
    ``fused_ce_bwd_plain`` on the same inputs: the forward as
    ``check_ce_fwd`` (``repeats`` more launches alike); dx, both backward
    versions fed the plain lse, within CE_DX_TOL and CE_SOFTMAX_TOL and
    exactly zero on rows whose cotangent is 0.  ``fault``: kernel 9 also
    runs under ``wrong_softmax``, which the dx check must fail."""
    import torch
    from moka_tpu_torch.ops import fused_ce as fc
    e_fwd, rlse = check_ce_fwd(name, x, w, scale, t, repeats)
    dx = fc.fused_ce_bwd(x, w, scale, t, rlse, cot)
    rdx = fc.fused_ce_bwd_plain(x, w, scale, t, rlse, cot)
    soft = rdx.float() - onehot_part(w, scale, t, cot)
    e = dx_errors(dx, rdx, soft)
    zeros = bool((dx[cot == 0] == 0).all())
    ok = zeros and dx_ok(e) and bool(torch.isfinite(dx.float()).all())
    log(f"  fused CE bwd {name}: dx max|err| {e['max_abs']:.3e} "
        f"({e['max_frac']:.2e} of max|plain|), rel L2 {e['rel_l2']:.2e}, "
        f"{e['softmax_rel_l2']:.2e} of the softmax term (softmax term "
        f"{float(soft.norm() / rdx.float().norm()):.2e} of dx; tol "
        f"{CE_DX_TOL[0]}, {CE_DX_TOL[1]}, {CE_SOFTMAX_TOL}); zero-cotangent "
        f"rows zero {zeros}")
    if not ok:
        raise AssertionError(f"kernel 9 disagrees with its plain version "
                             f"({name})")
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
    return e_fwd, e["max_abs"]


CE_CLUSTER_CASE = (300, 64, 1500)  # kernel 8's clusters cut ragged: three
# 128-row blocks (a cluster holds two; its ablation's 2 x 2 clusters also
# two of the three 512-column spans), d 64 (two stages, fewer than a ring
# holds)


def ce_records(n, d, v) -> list[dict]:
    """Check kernels 8-9 at the main path's shape (route B: N = 4 x 1023
    rows, d 4096, V 32011) and four ragged ones (rows and vocab off the
    tiles: both kernels' 128 rows and 512 vocab columns a CTA, 256 a stage;
    kernel 8's clusters, CE_CLUSTER_CASE), kernel 8 launched
    CE_REPEATS more times at the main shape and the cluster case with
    every nll and lse bit-identical; launched as each CE_FWD_MUTANTS fault
    kernel 8 must fail its check at both.  Then time each kernel at the
    main path's shape beside its plain version and
    the library's int8 -> bf16 cast of the head, bf16 ``torch.matmul``,
    the scale and ``F.cross_entropy(reduction="none")`` (kernel 9: that
    forward's autograd backward alone); kernel 9 also alone, without the
    wrapper's zero fill of the fp32 workspace and its cast to bf16."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import fused_ce as fc
    err_f = err_b = 0.0
    repeated = {}
    for name, shape, seed in (("main path shape", (n, d, v), 0),
                              ("ragged rows and vocab", (333, 192, 1000), 1),
                              ("one row block", (50, 64, 203), 2),
                              ("ragged across kernel 9's tiles",
                               (1000, 4096, 5000), 4),
                              ("ragged across kernel 8's clusters",
                               CE_CLUSTER_CASE, 5)):
        inputs = ce_case(*shape, seed)
        repeats = CE_REPEATS if seed in (0, 5) else 0
        ef, eb = check_ce(name, *inputs, fault=seed == 0, repeats=repeats)
        err_f, err_b = max(err_f, ef), max(err_b, eb)
        if repeats:
            repeated[name] = inputs[:4]
    for what, lib in MUTANTS["fused_ce"].items():
        with swapped_library("fused_ce", lib):
            for name, inputs in repeated.items():
                must_fail(f"kernel 8 mutant ({what}, {name})",
                          lambda: check_ce_fwd(name, *inputs))
    del repeated
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
            "tolerance": (f"nll, lse {CE_LSE_TOL}; {CE_REPEATS} more "
                          f"launches bit-identical" if which == "fwd" else
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


BD_REPEAT = (1, 512, 8, 4096)  # kernel 10's fp32 path at b 8, where a race
BD_REPEATS = 100               # between a warp's reads of a stage and the
                               # next TMA write into it showed in about one
                               # launch in twenty before the stage release
                               # fenced the async proxy


def repeat_block_diag(blocks, x) -> None:
    """Kernel 10 launched BD_REPEATS times on the same input: every result
    must equal the first (the kernel is deterministic) and the plain
    version (``check_block_diag``'s limit).  Raises otherwise."""
    import torch
    from moka_tpu_torch.ops import fbd
    check_block_diag(blocks, x)
    first = fbd.block_diag_matmul(blocks, x)
    bad = sum(not torch.equal(fbd.block_diag_matmul(blocks, x), first)
              for _ in range(BD_REPEATS))
    log(f"  block_diag {tuple(blocks.shape)} x {tuple(x.shape)} "
        f"{str(x.dtype)[6:]}: {BD_REPEATS} more launches, {bad} differ from "
        f"the first")
    if bad:
        raise AssertionError(f"kernel 10 is not deterministic: {bad} of "
                             f"{BD_REPEATS} launches differ")


def block_diag_records() -> list[dict]:
    """Kernel 10 against the plain einsum on bf16 W and orthogonal fp32
    blocks (Cayley of N(0, 0.1^2)) at the merge's three shapes and at
    BD_EXTRA (b 16, 24, 32; fp32 x), within ``check_block_diag``'s limits,
    and BD_REPEATS launches at BD_REPEAT all alike; launched as the mutant
    that reads each block transposed it must fail.
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
    repeat_block_diag(*case(*BD_REPEAT, torch.float32))
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
    out the mean of V, lse ~-6.9e29 to 1e-6 of itself).  The backward's
    early exits keep the contract exactly: dq is 0 on every row that sees
    no key, dk and dv 0 on every key no query sees; and it sums in a fixed
    order: a second launch of each backward kernel is bit-identical."""
    import torch
    from moka_tpu_torch.ops import flash_attention as fa
    out, lse = fa.flash_rank_fwd(q, k, v, mask, q_offset, causal)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()

    def backward():
        dq = fa.flash_rank_bwd_dq(q, k, v, mask, dout, lse, delta, q_offset,
                                  causal)
        return (dq, *fa.flash_rank_bwd_dkv(q, k, v, mask, dout, lse, delta,
                                           q_offset, causal))

    dq, dk, dv = backward()
    again = backward()
    torch.cuda.synchronize()
    repeat_ok = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    del again
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
    seen = _visible(mask, L, S, q_offset, causal).any(dim=1)  # (b, S)
    zeros_ok = not dq[~live].any() and not dk[~seen].any() and \
        not dv[~seen].any()
    ok = dead_ok and zeros_ok and repeat_ok and \
        all(errs[n] <= RANK_TOL for n in ("out", "lse")) and \
        all(errs[n] <= RANK_BWD_TOL for n in ("dq", "dk", "dv"))
    log(f"  rank flash {name}: q {tuple(q.shape)}, q_offset {q_offset}, "
        f"causal {causal}, rows that see no key {int((~live).sum())}, keys "
        f"no query sees {int((~seen).sum())}: max|err| / max|plain| " +
        ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) +
        f"; their lse ok {dead_ok}, their gradients exactly 0 {zeros_ok}, "
        f"the backward bit-identical on repeat {repeat_ok} (tol {RANK_TOL} "
        f"fwd, {RANK_BWD_TOL} bwd)")
    if not ok:
        raise AssertionError(f"rank flash kernels disagree with their "
                             f"plain versions ({name})")
    return {n: e * float(t.abs().max()) for (n, e), t in
            zip(errs.items(), (ref, want2[live], *grads))}


def rank_flash_records(b, L) -> list[dict]:
    """The rank route's three kernels (TPU kernels 1-4 at head_dim 4,
    fp32) checked on ``rank_check_cases`` (the forward's key layouts,
    causal rows before the first visible key, a ragged L, no-question
    samples); the forward launched as each RANK_MUTANTS fault and the
    backward as each RANK_BWD_MUTANTS fault must fail there.  Then each kernel timed at (b, L) with every sample's question
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
        if what in RANK_WIDE_MUTANTS:
            continue  # phase 20's
        with swapped_library("flash_rank", lib):
            must_fail(f"rank mutant ({what})",
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


# ----------------------------------------------- phase 3: the decode kernel

DECODE_TOL = FLASH_OUT_TOL  # kernel 1's rule, per element: both sides sum
                  # in fp32 (the kernel in base 2 on a prescaled q, in other
                  # orders) and round out to bf16 once
DECODE_CASES = (  # name, (B, H, K, S, length), left pads, rows without keys
    ("7B serving", (8, 32, 32, 1024, 928), (0, 1, 2, 3, 4, 5, 6), (7,)),
    ("7B serving, infer and eval_vt's cache (pad-to 1024 + 32)",
     (8, 32, 32, 1280, 1025), (0, 7, 1, 6, 2, 5, 3, 0), (4,)),
    ("llama2_70b heads, GQA 64:8", (4, 64, 8, 1024, 700), (0, 3, 0, 9),
     (2,)),
    ("one 256-key block", (2, 32, 32, 256, 200), (0, 5), ()),
    ("one sample, several spans", (1, 32, 32, 4096, 3000), (5,), ()))
DECODE_LAYERS = 2  # layers of a checked cache; the kernel reads layer 1
DECODE_REPEATS = 20  # launches on one input, all bit-identical: the spans
                     # merge in span order whichever CTA comes last
DECODE_SERVING = DECODE_CASES[:2]  # the repeats' and the mutants' cases:
                     # one span a pair with a 32-key and a one-key last tile
                     # (phase 16's first decode step) ...
DECODE_SPLIT = DECODE_CASES[4]  # ... and eight spans a pair (the merge)
DECODE_TIMED = DECODE_CASES[:3]  # timed: serving, infer's cache, GQA 64:8


def decode_case(B, H, K, S, length, pads, dead, quantized, seed):
    """q (B, 1, H, 128) bf16 and a (DECODE_LAYERS, B, S, K, 128) cache from
    ``seed``, bf16 or int8 (``_kv_quantize``'s codes and scales), its
    cells at and past ``length`` poisoned (k +1e6, v -1e6); an int32 mask
    with row i's first pads[i] keys masked and the ``dead`` rows fully
    masked."""
    import torch
    from moka_tpu_torch.models.llama import _kv_quantize
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, H, 128), generator=g, device="cuda").bfloat16()
    shape = (DECODE_LAYERS, B, S, K, 128)
    k = torch.randn(shape, generator=g, device="cuda")
    v = torch.randn(shape, generator=g, device="cuda")
    k[:, :, length:] = 1e6
    v[:, :, length:] = -1e6
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    for i in dead:
        mask[i] = 0
    if not quantized:
        return q, k.bfloat16(), v.bfloat16(), mask
    (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
    return q, {"q": kq, "s": ks}, {"q": vq, "s": vs}, mask


def check_decode(name, q, ck, cv, mask, length, layer=1) -> float:
    """The decode kernel against ``paged_decode_attention_plain`` on the
    rows that see a key (DECODE_TOL); a row that sees no key must read out
    exactly 0 (the plain loop gives it the mean of the values it walked);
    every value finite (the poisoned tail is never read)."""
    import torch
    from moka_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_plain)
    out = paged_decode_attention(q, ck, cv, mask, layer, length)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q, ck, cv, mask, layer, length)
    rows = (mask[:, :length] > 0).any(dim=1)
    atol, rtol = DECODE_TOL
    diff = (out.float() - ref.float()).abs()[rows]
    excess = float((diff - rtol * ref.float().abs()[rows]).max())
    d_out = float(diff.max())
    dead_ok = bool((out[~rows] == 0).all())
    finite = bool(torch.isfinite(out).all())
    log(f"  decode {name}: q {tuple(q.shape)} length {length}: max|err| "
        f"{d_out:.3e}, max(|err| - {rtol:.4g}|plain|) {excess:.3e} (tol "
        f"{atol}), rows with keys {int(rows.sum())}/{rows.numel()}, rows "
        f"without keys out 0: {dead_ok}, finite {finite}")
    if not (excess <= atol and dead_ok and finite):
        raise AssertionError(f"decode kernel disagrees with its plain "
                             f"version ({name})")
    return d_out


def decode_spans(shape) -> int:
    """The decode kernel's spans a (sample, kv head) at ``shape`` (B, H,
    K, S, length) on this card."""
    import torch
    from moka_tpu_torch.ops.paged_decode import plan_spans
    B, _, K, _, length = shape
    return plan_spans(B, K, length, torch.cuda.get_device_properties(
        0).multi_processor_count)[1]


def decode_timing(shape, pads, dead, quantized, seed) -> dict:
    """The decode kernel at ``shape`` on one cache: the wrapper back to
    back (ms), the kernel alone (``profile_port.graph_ms``: a CUDA graph
    of 100 launches), the host's µs a call (``profile_port.host_us``), the
    plain loop and the library call, SDPA over the valid prefix with the
    boolean mask (the int8 cache dequantized first, in the same call's
    time), whose output must be the plain version's; and the bound: the
    visible key rows' k and v bytes (and scales), q and out, at 3.35
    TB/s."""
    import torch
    import torch.nn.functional as F
    import profile_port
    from moka_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_plain)
    B, H, K, S, length = shape
    q, ck, cv, mask = decode_case(*shape, pads, dead, quantized, seed=seed)
    qs = q.transpose(1, 2)
    bmask = (mask[:, :length] > 0)[:, None, None, :]

    def prefix(side):
        if isinstance(side, dict):
            side = (side["q"][1, :, :length].float() *
                    side["s"][1, :, :length]).bfloat16()
        else:
            side = side[1, :, :length]
        return side.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(
            qs, prefix(ck), prefix(cv), attn_mask=bmask, enable_gqa=True)

    def kernel():
        return paged_decode_attention(q, ck, cv, mask, 1, length)

    rows = bmask[:, 0, 0].any(dim=1)
    ref = paged_decode_attention_plain(q, ck, cv, mask, 1, length)
    lib_err = float((library().transpose(1, 2).float() - ref.float())
                    .abs()[rows].max()) / float(ref.float().abs().max())
    if lib_err > SAME_FUNCTION_TOL:
        raise AssertionError(f"the decode yardstick computes another "
                             f"function: {lib_err:.3e}")
    ms = time_ms(kernel, iters=50, warmup=5)
    device_ms = profile_port.graph_ms(kernel)
    host_us = profile_port.host_us(kernel)
    plain_ms = time_ms(lambda: paged_decode_attention_plain(
        q, ck, cv, mask, 1, length), iters=5, warmup=1)
    lib_ms = time_ms(library, iters=50, warmup=5)
    visible = int(bmask.sum())            # (sample, key) pairs
    row_bytes = 128 * (1 if quantized else 2) + (4 if quantized else 0)
    n_bytes = 2 * visible * K * row_bytes + 2 * nbytes(q)
    bms, by = bound_ms(n_bytes, 4.0 * 128 * visible * H, FP32_FLOPS)
    return {"ms": ms, "device_ms": device_ms, "host_us": host_us,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "library_rel_err": lib_err,
            "spans": decode_spans(shape)}


def decode_records() -> list[dict]:
    """The decode kernel on DECODE_CASES, bf16 and int8 caches (length not
    a multiple of 64, a poisoned tail, left pads, a row without keys, one
    span and several); on each DECODE_SERVING case and DECODE_SPLIT with an
    int8 cache, DECODE_REPEATS launches bit-identical and each
    DECODE_MUTANTS fault failing (those of DECODE_MERGE_MUTANTS where a
    pair has several spans: DECODE_SPLIT); then timed (``decode_timing``)
    at DECODE_TIMED on each cache.  The record is the 7B serving shape's,
    the other timed shapes under ``at``."""
    import torch
    from moka_tpu_torch.ops.paged_decode import paged_decode_attention
    err = {False: 0.0, True: 0.0}
    for i, (name, shape, pads, dead) in enumerate(DECODE_CASES):
        for quantized in (False, True):
            case = decode_case(*shape, pads, dead, quantized, seed=40 + i)
            err[quantized] = max(err[quantized], check_decode(
                f"{name} ({decode_spans(shape)} span(s) a pair), "
                f"{'int8' if quantized else 'bf16'} cache", *case, shape[4]))
    for i, (name, shape, pads, dead) in enumerate((*DECODE_SERVING,
                                                   DECODE_SPLIT)):
        length, split = shape[4], decode_spans(shape) > 1
        q, ck, cv, mask = decode_case(*shape, pads, dead, True, seed=50 + i)
        first = paged_decode_attention(q, ck, cv, mask, 1, length)
        same = all(torch.equal(first, paged_decode_attention(
            q, ck, cv, mask, 1, length)) for _ in range(DECODE_REPEATS))
        log(f"  decode {name}, int8: {DECODE_REPEATS} more launches "
            f"bit-identical: {same}")
        if not same:
            raise AssertionError("decode kernel: repeated launches differ")
        for what, lib in MUTANTS["paged_decode"].items():
            if what in DECODE_MERGE_MUTANTS and not split:
                continue
            with swapped_library("paged_decode", lib):
                must_fail(f"decode kernel mutant ({what}), {name}",
                          lambda: check_decode(f"{name}, int8, mutant", q,
                                               ck, cv, mask, length))
        del q, ck, cv, mask
    records = []
    for quantized in (False, True):
        kind = "int8" if quantized else "bf16"
        at = {}
        for i, (name, shape, pads, dead) in enumerate(DECODE_TIMED):
            at[name] = t = decode_timing(shape, pads, dead, quantized,
                                         seed=45 + i)
            log(f"  decode timing {name}, {kind} cache ({t['spans']} "
                f"span(s) a pair): kernel alone {t['device_ms']:.4f} ms, "
                f"back to back {t['ms']:.4f} ms, host {t['host_us']:.1f} "
                f"us a call, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms (its output within "
                f"{t['library_rel_err']:.2e} of the plain version's), bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}; "
                f"{t['bound_ms'] / t['device_ms']:.0%} of it alone)")
        name, (B, H, K, S, length), _, _ = DECODE_TIMED[0]
        main = at.pop(name)
        records.append({
            "name": "paged_decode" + ("_int8" if quantized else ""),
            "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/paged_decode.cu",
            "replaces": "moka_tpu/ops/paged_decode.py:40 (not a Pallas "
                        "kernel; an XLA loop in JAX)",
            "launches": None, "max_abs_err": err[quantized],
            "tolerance": f"|err| <= {DECODE_TOL[0]} + "
                         f"{DECODE_TOL[1]:.4g}|plain| on rows with keys; 0 "
                         f"on rows without",
            **main,
            "library": "scaled_dot_product_attention over the valid prefix "
                       "with the boolean mask, enable_gqa" +
                       (", the int8 prefix dequantized first" if quantized
                        else ""),
            "shape": f"B {B}, H {H}, K {K}, S {S}, length {length}, one "
                     f"layer, {kind} cache; ms the wrapper back to back, "
                     f"device_ms a CUDA graph of launches",
            "at": at})
    return records


def decode_launches(cfg, capacity: int, new_tokens: int,
                    kv_quant: bool = False, calls: int = 1) -> dict:
    """The decode kernel's launches of ``calls`` generate calls of
    ``new_tokens`` at cache ``capacity``: one a layer each decode step when
    ``paged_decode_auto`` takes the paged path, else none (``_launches``
    keywords)."""
    from moka_tpu_torch.eval.decode import paged_decode_auto
    if not paged_decode_auto(cfg, capacity, kv_quant, device="cuda"):
        return {}
    n = calls * (new_tokens - 1) * cfg.n_layers
    return {"paged_decode": n, **({"paged_decode_int8": n} if kv_quant
                                  else {})}


GATE_CAPACITIES = (512, 1024, 2048, 4096)  # paged_decode_auto's readings
GATE_TURNS = 5   # rounds of eager, paged, paged, eager blocks a reading
GATE_STEPS = 2   # decode steps a block, after one warm-up block a path


def paged_gate_readings(cfg, spec, base, adapters, batch: int = 8,
                        device: str = "cuda",
                        capacities=GATE_CAPACITIES,
                        steps: int = GATE_STEPS,
                        turns: int = GATE_TURNS) -> dict:
    """The measurements behind ``decode.paged_decode_auto``: the 7B decode
    step (one token for ``batch`` lanes through ``llama.forward``, host
    and card, synchronised) eager against paged, on a bf16 and an int8
    cache of each capacities size holding random values, at position
    capacity - 16: one warm-up block a path, then ``turns`` rounds of
    eager, paged, paged, eager blocks of ``steps`` steps, so that each
    round holds two pairings of an eager and a paged block side by side
    (the host's drift falls on both alike).

    The rule: paged on a cache when the paged block was faster in more
    than half of that cache's pairings, pooled over every capacity
    measured.  Returns {"bf16"|"int8": {"by_capacity": {capacity:
    {"eager_ms", "paged_ms" (each path's median block), the blocks,
    "paged_won" (its pairings)}}, "pairings", "paged_won", "paged" (the
    rule's answer)}}."""
    import torch
    from moka_tpu_torch.models import llama
    g = torch.Generator(device=device).manual_seed(17)
    tok = torch.randint(3, cfg.vocab_size, (batch, 1), generator=g,
                        device=device)
    out: dict = {}
    for kv_quant in (False, True):
        kind = "int8" if kv_quant else "bf16"
        rows = {}
        for cap in capacities:
            cache = llama.init_kv_cache(cfg, batch, cap, quantized=kv_quant,
                                        device=device)
            for side in (cache["k"], cache["v"]):
                if kv_quant:
                    side["q"].random_(-127, 128, generator=g)
                    side["s"].fill_(0.02)
                else:
                    side.normal_(0.0, 1.0, generator=g)
            pos = cap - 16
            cache["length"] = pos
            mask = torch.ones((batch, cap), dtype=torch.int32, device=device)
            positions = torch.full((batch, 1), pos, device=device)
            blocks: dict = {False: [], True: []}

            def block(paged):
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(steps):
                    llama.forward(base, cfg, adapters=adapters, spec=spec,
                                  tokens=tok, attn_mask=mask,
                                  positions=positions, cache=cache,
                                  paged_decode=paged)
                _sync(device)
                return (time.perf_counter() - t0) / steps * 1e3

            with torch.inference_mode():
                block(False)
                block(True)
                for _ in range(turns):
                    for paged in (False, True, True, False):
                        blocks[paged].append(block(paged))
            won = sum(p < e for e, p in zip(blocks[False], blocks[True]))
            rows[cap] = {"eager_ms": float(np.median(blocks[False])),
                         "paged_ms": float(np.median(blocks[True])),
                         "eager_blocks_ms": blocks[False],
                         "paged_blocks_ms": blocks[True], "paged_won": won}
            del cache
            if device == "cuda":
                torch.cuda.empty_cache()
            log(f"  decode step b {batch}, {kind} cache of {cap}: eager "
                f"{rows[cap]['eager_ms']:.2f} ms "
                f"({min(blocks[False]):.2f}-{max(blocks[False]):.2f}), "
                f"paged {rows[cap]['paged_ms']:.2f} ms "
                f"({min(blocks[True]):.2f}-{max(blocks[True]):.2f}), "
                f"medians of {len(blocks[True])} blocks of {steps} steps; "
                f"paged faster in {won} of {len(blocks[True])} pairings")
        n = sum(len(r["paged_blocks_ms"]) for r in rows.values())
        won = sum(r["paged_won"] for r in rows.values())
        out[kind] = {"by_capacity": rows, "pairings": n, "paged_won": won,
                     "paged": 2 * won > n}
        log(f"  {kind} cache: paged faster in {won} of {n} pairings over "
            f"the capacities {list(capacities)}: paged {2 * won > n}")
    return out


def check_paged_gate(cfg, readings: dict, device: str) -> None:
    """``decode.paged_decode_auto`` answers as the readings' rule does, at
    every capacity measured, on both caches; raises otherwise."""
    from moka_tpu_torch.eval.decode import paged_decode_auto
    for kv_quant, kind in ((False, "bf16"), (True, "int8")):
        rows = readings[kind]
        auto = {c: paged_decode_auto(cfg, c, kv_quant, device=device)
                for c in rows["by_capacity"]}
        if any(a != rows["paged"] for a in auto.values()):
            raise AssertionError(
                f"paged_decode_auto on a {kind} cache answers {auto}, the "
                f"readings {rows['paged']} (paged faster in "
                f"{rows['paged_won']} of {rows['pairings']} pairings)")


# ------------------------------------------------------------------ phase 4

def build_model(cfg, spec, seed=0, device="cuda"):
    """bf16 LLaMA base and fp32 MokA adapters on the card (or ``device``),
    random from ``seed``; B is seeded non-zero (it starts at zero, a
    no-op)."""
    import torch
    from moka_tpu_torch.models import llama
    g = torch.Generator(device=device).manual_seed(seed)
    base = llama.init_llama_params(g, cfg, device=device,
                                   dtype=torch.bfloat16)
    adapters = llama.init_moka_adapters(g, cfg, spec, device=device)
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

    def logits(params, kernels, dtype):
        h, _, _ = prefill(
            params, adapters, cfg=cfg, spec=spec,
            **dict(inputs, inputs_embeds=inputs["inputs_embeds"].to(dtype)),
            max_new_tokens=new_tokens, use_flash=kernels,
            use_fused_moka=kernels)
        return llama.head_logits(h, params["lm_head"])

    # kernel 1's launches and kernel 5's (``moka_launches``: past rank 64
    # its wide path's and R1's)
    want = _launches(flash_fwd=cfg.n_layers,
                     **moka_launches(spec, 7 * cfg.n_layers))
    names = ("flash_fwd", "moka_delta_fwd", *MOKA_MORE_COUNTS,
             "flash_rank_fwd")
    want = {k: want[k] for k in names}
    with torch.inference_mode():
        _zero_counts()
        got = logits(base, True, torch.bfloat16)
        counts = {k: v for k, v in _counts().items() if k in names}
        ref = base if plain_base is None else plain_base
        plain = logits(ref, False, torch.bfloat16)
        base32 = float32(ref)  # a quantized base keeps its codes
        exact = logits(base32, False, torch.float32)
        del base32
    log(f"  kernel prefill: launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"prefill launches {counts}, want {want}")
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
              what: str, warm: bool = False, prefill_runs: int = 3) -> dict:
    """Times ``gen(1)`` (the prefill and the head on its last row, no
    decode step; median of ``prefill_runs``) and ``gen(new_tokens)`` (the
    main path: launch counts zeroed just before, read just after, and
    required to equal ``want``), after a warm-up ``gen(new_tokens)``
    unless the caller ran these shapes already (``warm``).  Decode = the
    difference; its cache is new_tokens - 1 positions longer."""
    import torch

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen(n)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    with torch.inference_mode():
        if not warm:
            gen(new_tokens)
        runs = sorted(timed(1)[1] for _ in range(prefill_runs))
        prefill_s = runs[len(runs) // 2]
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


KV8_LOGIT_TOL = 0.2  # each decode step's logits on the int8 cache, eager
                  # or paged, against the bf16 cache's (eager), teacher-
                  # forced on the same tokens, rel L2.  The codes round k and
                  # v to 1/254 of a row's max, and 32 random layers amplify
                  # any rounding: on the H100 the int8 cache read 0.105
                  # paged and 0.109 eager, the vs-dropped mutant 1.375 (a
                  # first limit of 5e-2, set before any reading, lay below
                  # the bf16 cache's own 5.6e-2 through the kernel)
KV_KERNEL_TOL = 0.1  # the same, the paged step against the eager one on the
                  # same cache, bf16 or int8, where only the decode kernel
                  # differs: bf16 read 5.6e-2 on the H100 before this limit
                  # was set; int8 had not been read


def paged_serving(cfg, spec, base, adapters, inputs, new_tokens) -> dict:
    """Phase 4's serving path through the decode kernel, on phase 4's base
    and prompts: ``greedy_generate`` with ``paged_decode=True`` on a bf16
    cache, then on an int8 one (``kv_quant``), each through ``main_path``
    (one decode-kernel launch a layer a decode step asserted); the tokens
    against the eager bf16 path's; then teacher-forced on the eager
    path's tokens, every decode step's logits: the paged step within
    KV_KERNEL_TOL rel L2 of the eager one on the same cache (bf16 and
    int8), and the int8 cache (eager and paged) within KV8_LOGIT_TOL of
    the bf16 cache (eager); each DECODE_MUTANTS fault but the merge's
    (DECODE_MERGE_MUTANTS: this path has one span a pair), on the int8
    cache,
    must exceed both.  The tokens' agreement with the eager path's is
    logged, not held: the random weights' logits are flat, and one
    rounding flips a token that every later step then feeds back."""
    import torch
    from moka_tpu_torch.eval.decode import greedy_generate, prefill
    from moka_tpu_torch.models import llama
    n, b = cfg.n_layers, inputs["inputs_embeds"].shape[0]
    kw = dict(cfg=cfg, spec=spec, max_new_tokens=new_tokens, eos_id=-1,
              **inputs)
    with torch.inference_mode():
        eager = greedy_generate(base, adapters, paged_decode=False, **kw)
    out = {}
    for kv_quant in (False, True):
        kind = "int8" if kv_quant else "bf16"
        out[kind] = main_path(
            lambda k, q=kv_quant: greedy_generate(
                base, adapters, **dict(kw, max_new_tokens=k),
                paged_decode=True, kv_quant=q), b, new_tokens,
            cfg.vocab_size,
            _launches(flash_fwd=n, moka_delta_fwd=7 * n,
                      paged_decode=(new_tokens - 1) * n,
                      paged_decode_int8=(new_tokens - 1) * n * kv_quant),
            f"greedy_generate, paged, {kind} cache")
        with torch.inference_mode():
            toks = greedy_generate(base, adapters, paged_decode=True,
                                   kv_quant=kv_quant, **kw)
        out[kind]["tokens_as_eager"] = float((toks == eager).float().mean())

    L = inputs["prompt_mask"].shape[1]
    n_prompt = inputs["prompt_mask"].sum(dim=-1)

    def forced(kv_quant, paged):
        with torch.inference_mode():
            _, cache, cmask = prefill(
                base, adapters, cfg=cfg, spec=spec, **inputs,
                max_new_tokens=new_tokens, use_flash=True,
                use_fused_moka=True, kv_quant=kv_quant, paged_decode=paged)
            steps = []
            for t in range(new_tokens - 1):
                cmask[:, L + t] = 1
                logits, cache = llama.forward(
                    base, cfg, adapters=adapters, spec=spec,
                    inputs_embeds=base["embed"][eager[:, t:t + 1].long()],
                    attn_mask=cmask, positions=(n_prompt + t)[:, None],
                    cache=cache, paged_decode=paged)
                steps.append(logits[:, -1].float())
        return torch.stack(steps, dim=1)

    def worst(got, ref):
        return float(((got - ref).norm(dim=(0, 2)) /
                      ref.norm(dim=(0, 2))).max())

    ref, ref8 = forced(False, False), forced(True, False)
    kernel = {"bf16": worst(forced(False, True), ref)}  # paged vs eager
    paged8 = forced(True, True)
    kernel["int8"] = worst(paged8, ref8)
    cache8 = {"eager": worst(ref8, ref), "paged": worst(paged8, ref)}
    mutants = {}
    for what, lib in MUTANTS["paged_decode"].items():
        if what in DECODE_MERGE_MUTANTS:  # one span a pair on this path
            continue
        with swapped_library("paged_decode", lib):
            got = forced(True, True)
        mutants[what] = {"vs int8 eager": worst(got, ref8),
                         "vs bf16 eager": worst(got, ref)}
    rel = {"kernel": kernel, "int8_cache": cache8, "mutants": mutants}
    log(f"  teacher-forced decode logits, worst step's rel L2: paged "
        f"against eager on the same cache {kernel} (limit {KV_KERNEL_TOL});"
        f" the int8 cache against the bf16 one (eager) {cache8} (limit "
        f"{KV8_LOGIT_TOL}); the mutants, which must exceed both, {mutants};"
        f" tokens as the eager path's: bf16 paged "
        f"{out['bf16']['tokens_as_eager']:.3f}, int8 paged "
        f"{out['int8']['tokens_as_eager']:.3f}")
    if not (max(kernel.values()) <= KV_KERNEL_TOL and
            max(cache8.values()) <= KV8_LOGIT_TOL) or any(
            not (m["vs int8 eager"] > KV_KERNEL_TOL and
                 m["vs bf16 eager"] > KV8_LOGIT_TOL)
            for m in mutants.values()):
        raise AssertionError(f"decode logits through the kernel: {rel}")
    out["forced_rel_l2"] = rel
    return out


OTHER_RANK = 8  # what moka_tpu/cli/infer.py --lora-r 8 serves on the TPU


def moka_launches(spec, calls: int, ring: bool = False) -> dict:
    """The launches of ``calls`` kernel-5 calls at ``spec``: up to rank 64
    one ``moka_delta_fwd`` each (and, under a ring, one key pass alone);
    past it the wide path's down and up products and R1 once for each
    attention stream."""
    from moka_tpu_torch.ops.moka_pallas import KERNEL_RANKS
    if spec.rank <= KERNEL_RANKS[-1]:
        return {"moka_delta_fwd": calls,
                "moka_delta_keys": calls if ring else 0}
    return {"moka_delta_wide_down": calls, "moka_delta_wide_up": calls,
            "flash_rank_fwd": calls * len(spec.attn_modalities)}


def serve_other_rank(cfg, base, inputs, new_tokens,
                     rank=OTHER_RANK, engine=True) -> dict:
    """A rank-``rank`` MokA AVT adapter tree (B seeded non-zero) on phase
    4's base: the prefill logits under phase 4's rule through both
    kernels (``check_logits``), then ``greedy_generate`` and (``engine``)
    one ``DecodeEngine`` request (the first prompt), each with its defaults,
    which must take kernel 5 (224 calls a prefill: ``moka_launches``)
    and return every token."""
    import torch
    from moka_tpu_torch.eval.engine import DecodeEngine
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.moka import MokaSpec
    spec = MokaSpec.avt(rank=rank, dropout_rate=0.0)
    g = torch.Generator(device="cuda").manual_seed(rank)
    adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
    for p in adapters["layers"].values():
        p["b"].normal_(0.0, 0.02, generator=g)
    check_logits(cfg, spec, base, adapters, inputs, new_tokens)
    L = inputs["prompt_mask"].shape[1]
    want = _launches(flash_fwd=cfg.n_layers,
                     **moka_launches(spec, 7 * cfg.n_layers),
                     **decode_launches(cfg, L + new_tokens, new_tokens))
    b = inputs["inputs_embeds"].shape[0]
    with torch.inference_mode():
        _zero_counts()
        toks = generate(cfg, spec, base, adapters, inputs, new_tokens)
        torch.cuda.synchronize()
        gen_launches = _counts()
    if gen_launches != want or tuple(toks.shape) != (b, new_tokens):
        raise AssertionError(f"rank {rank} greedy_generate: launches "
                             f"{gen_launches}, tokens {tuple(toks.shape)}")
    if not engine:
        log(f"  rank {rank}: greedy_generate b {b} launches "
            f"{ {k: v for k, v in gen_launches.items() if v} }")
        return {"rank": rank, "generate_launches": gen_launches}
    engine = DecodeEngine(base, adapters, cfg=cfg, spec=spec, n_slots=1,
                          cache_capacity=L + new_tokens, eos_id=-1,
                          cache_dtype=base["embed"].dtype)
    masks = inputs["masks"]
    _zero_counts()
    done = engine.submit(
        inputs["inputs_embeds"][:1],
        inputs["prompt_mask"][:1].float().cpu().numpy(),
        masks=llama.MaskBundle(masks.modality[:, :1], masks.question[:1]),
        max_new_tokens=new_tokens)
    with torch.inference_mode():
        engine.run_until_drained()
    out = done.get(timeout=600)
    eng_launches = _counts()
    log(f"  rank {rank}: greedy_generate b {b} launches "
        f"{ {k: v for k, v in gen_launches.items() if v} }; DecodeEngine "
        f"(fused delta {engine.use_fused_moka}) {len(out)} tokens, launches "
        f"{ {k: v for k, v in eng_launches.items() if v} }")
    if eng_launches != want or len(out) != new_tokens:
        raise AssertionError(f"rank {rank} DecodeEngine: launches "
                             f"{eng_launches}, {len(out)} tokens")
    return {"rank": rank, "generate_launches": gen_launches,
            "engine_launches": eng_launches, "engine_tokens": len(out)}


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


def train_batch(cfg, b, L, seed=0, device="cuda") -> dict:
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
    return {k: torch.as_tensor(v, device=device) for k, v in
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
                busy=False, n_warm=2, n_timed=2, loss_fn=None,
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


def fused_other_specs():
    """Adapter trees the fused-dropout path takes beside AVT rank 4: AVT at
    rank 8 (M*r 24) and VT (two modalities, M*r 8), with phase 8's options
    (dropout 0.05, the 256-key question window, bf16 dots)."""
    from moka_tpu_torch.ops.moka import MokaSpec
    return {name: spec.with_question_window(256).with_bf16_dots()
            .with_fused_dropout() for name, spec in (
                ("AVT r8", MokaSpec.avt(rank=8, dropout_rate=0.05)),
                ("VT r4", MokaSpec.vt(rank=4, dropout_rate=0.05)))}


def check_fused_other_specs(cfg, frozen, batch) -> dict:
    """Phase 8's SHALLOW-layer gradient check (kernels 6-7 and flash
    against the plain path and fp32, ``_check_train_grads``) on each of
    ``fused_other_specs``' trees (random adapters, B non-zero); VT's two
    modality masks are the batch's text and its video and audio spans
    together."""
    import dataclasses
    import torch
    from moka_tpu_torch.models import llama
    n = SHALLOW
    cfg = dataclasses.replace(cfg, n_layers=n)
    frozen = first_layers(frozen, n)
    out = {}
    for i, (name, spec) in enumerate(fused_other_specs().items()):
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
        for p in adapters["layers"].values():
            p["b"].normal_(0.0, 0.02, generator=g)
        b = dict(batch)
        mod = batch["modality_masks"]
        if spec.num_modalities == 2:
            b["modality_masks"] = torch.stack([mod[0], mod[1] + mod[2]])
        log(f"  {n} layers, proj_lse, {name} (M*r "
            f"{spec.num_modalities * spec.rank}):")
        out[name] = _check_train_grads(cfg, spec, frozen,
                                       {"adapters": adapters}, b,
                                       policy="proj_lse", key_seed=13 + i)
        del adapters
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
    """Route B (``pallas_ce``: kernels 8-9) for 2 + 3 steps with a traced
    step, then route A (the chunked CE on the a8 head) for 1 + 3, each
    from the same adapters and key: launches a step asserted, losses must
    fall, and the two routes' first losses (same forward, other head
    product) agree within HEAD_ROUTES_TOL."""
    out = {}
    for route, kw, steps in (("B", dict(pallas_ce=True), (2, 3)),
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
    """Phase 11 at full depth: 2 warm-up and 2 timed steps under full remat
    (asserting 64 flash forward and 32 fused backward launches, 14 rank
    calls a layer forward, all rerun by the recompute, and their dq and
    dk/dv a step) with a traced step; then one ``proj_lse`` step, whose
    recompute reruns none of them."""
    n = cfg.n_layers
    calls = 2 * len(PROJS) * n  # 2 attending modalities, 7 projections
    run = train_steps(cfg, spec, frozen, clone_tree(trainable), batch,
                      busy=True, n_warm=2, n_timed=2)
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
    capacity = embeds.shape[1] + new_tokens
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
                              moka_delta_fwd=7 * ucfg.llama.n_layers,
                              **decode_launches(ucfg.llama, capacity,
                                                new_tokens)),
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


def mm_loss_and_grads(ucfg, frozen, trainable, batch, kernels, key,
                      loss_for=mm_loss):
    """(loss, {group: its gradients, flat}) of ``loss_for(ucfg, kernels)``:
    a group per adapter projection and per projector (the Q-Formers' text
    branch, which no question reaches, in zeros)."""
    import torch
    from moka_tpu_torch.train.optim import tree_leaves
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_for(ucfg, kernels)(trainable, frozen, batch, key)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    flat = {}
    for path, g in zip(_paths(trainable), grads):
        group = path[2] if path[0] == "adapters" else path[0]
        flat.setdefault(group, []).append(g.flatten())
    return float(loss.detach()), {k: torch.cat(v) for k, v in flat.items()}


def check_mm_grads(ucfg, frozen, trainable, batch, loss_for=mm_loss,
                   what="multimodal step") -> dict:
    """At SHALLOW decoder layers with the full towers: the loss
    (``loss_for(ucfg, kernels)``) and the gradients of every adapter
    projection and every projector through the kernels, against the plain
    path (eager attention in the decoder and the CLIP tower, the other
    plain versions: ``plain_versions``) and an fp32 run (the same values in
    fp32, integer codes kept), same dropout key, under phase 6's rule; the
    loss's floor is MM_LOSS_FLOOR nats."""
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
    kern = mm_loss_and_grads(ucfg, frozen, trainable, batch, True, key,
                             loss_for)
    frozen32 = float32(frozen)
    with plain_versions():
        plain = mm_loss_and_grads(ucfg, frozen, trainable, batch, False, key,
                                  loss_for)
        exact = mm_loss_and_grads(ucfg, frozen32, trainable, batch, False,
                                  key, loss_for)
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
        raise AssertionError(f"{what}: the kernel path is further from fp32 "
                             f"than the plain bf16 path allows")
    return out


def mm_steps(ucfg, frozen, trainable) -> dict:
    """Phase 13: ``bench.py::run_multimodal``'s step on the stack (b 4 x
    L 1024, MM_LOSS, ``make_optimizer(TrainConfig(), 1000)``, the
    trainable tree {adapters, vl_projector, al_projector}): the SHALLOW
    gradient check, then at full depth 2 warm-up and 2 timed steps with a
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


# ----------------------------------------------------------------- phase 14

VT_ITEMS, VT_NEW_TOKENS = 8, 32  # MMBench items a generate call; new tokens
SP_PIECES = 32000  # LLaMA-2's SentencePiece vocabulary; the 11 multimodal
                   # tokens follow it (vocab 32011, phase 9's base)
VT_LOSS = dict(remat=True, fused_loss=True, remat_policy="proj_lse",
               a8_dots="full", save_q8=True)  # bench.py:570-571 with flash
HOST_DECODERS = ("PIL", "pandas")  # what the VT eval's items need: PIL
                   # decodes the PNGs (and the HTTP image), pandas reads the
                   # MMBench TSV
VT_QUESTIONS = (  # question, options A-D, answer, hint, image (w, h)
    ("What color dominates the picture?", ("red", "green", "blue", "gray"),
     "C", "Look at the whole picture.", (640, 480)),
    ("Which animal appears in the image?", ("cat", "dog", "horse", "bird"),
     "A", None, (336, 336)),
    ("How many objects are on the table?", ("one", "two", "three", "four"),
     "B", "Count only whole objects.", (224, 224)),
    ("Where was this photo most likely taken?",
     ("beach", "forest", "kitchen", "street"), "D", None, (500, 300)),
    ("What is the person in the image doing?",
     ("running", "reading", "cooking", "sleeping"), "B",
     "The person is seated.", (300, 500)),
    ("Which season does the scene show?",
     ("spring", "summer", "autumn", "winter"), "D", None, (512, 384)),
    ("What shape is the largest object?",
     ("circle", "square", "triangle", "star"), "A", None, (128, 96)),
    ("What time of day is it?", ("morning", "noon", "evening", "night"),
     "C", "Notice the light.", (250, 250)))


def vt_config():
    """``vt_7b_int4a8f_qh_qenc_sq8plse`` (``bench.py:570-571``, run by
    ``bench.py::run_vt``, :438-555): ``LlavaConfig.vt_7b``'s spec (MokA VT
    r4, attention weight 0.05, dropout 0.05) with bf16 dots, over phase
    9's int4 LLaMA-2-7B (int8 head, vocab 32011) and phase 12's int8 CLIP
    ViT-L/14 (weight-only: the row quantizes the tower without W8A8 dots;
    its attention through kernel 1 at head_dim 64), with the visual
    Q-Former projector; the tower stops at ``select_layer`` 23."""
    import dataclasses
    from moka_tpu_torch.models.llava import LlavaConfig
    cfg, _ = quant_train_config()
    vcfg = LlavaConfig.vt_7b(vocab_size=cfg.vocab_size)
    return dataclasses.replace(
        vcfg, llama=cfg, clip=dataclasses.replace(vcfg.clip, use_flash=True),
        spec=vcfg.spec.with_bf16_dots())


def build_vt_stack(vcfg, llama_frozen, clip, seed=9):
    """Phase 9's int4 base and phase 12's int8 CLIP tree as the frozen
    {llama, clip}; the fp32 visual projector and MokA VT adapters (B seeded
    non-zero) built on the card from ``seed``."""
    import torch
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.models.projectors import init_projector_params
    g = torch.Generator(device="cuda").manual_seed(seed)
    adapters = llama.init_moka_adapters(g, vcfg.llama, vcfg.spec,
                                        device="cuda")
    for p in adapters["layers"].values():
        p["b"].normal_(0.0, 0.02, generator=g)
    return {"llama": llama_frozen, "clip": clip}, {
        "projector": init_projector_params(g, vcfg.projector, device="cuda"),
        "adapters": adapters}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited field
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _vi(field: int, val: int) -> bytes:  # varint field
    return _varint(field << 3) + _varint(val)


def sp_model_bytes(words) -> bytes:
    """A SentencePiece ``tokenizer.model`` (a ``ModelProto``: BPE with byte
    fallback, dummy prefix) of SP_PIECES pieces, serialized by hand as
    ``tests/test_spm.py`` does: <unk>, <s>, </s>, the 256 byte pieces, ▁
    and every prefix of ▁``word`` for each of ``words`` (a longer prefix
    scores higher, so the merges build each word), then filler pieces."""
    w = "▁"
    pieces = [("<unk>", 2), ("<s>", 3), ("</s>", 3)] + \
        [(f"<0x{b:02X}>", 6) for b in range(256)] + [(w, 1)]
    seen = {p for p, _ in pieces}
    for word in words:
        for i in range(1, len(word) + 1):
            if w + word[:i] not in seen:
                seen.add(w + word[:i])
                pieces.append((w + word[:i], 1))
    pieces += [(f"{w}filler{k}", 1) for k in range(SP_PIECES - len(pieces))]
    blob = b"".join(_ld(1, _ld(1, p.encode()) + _varint(2 << 3 | 5) +
                        struct.pack("<f", float(len(p)) if t == 1 else 0.0)
                        + _vi(3, t)) for p, t in pieces)
    return blob + _ld(2, _vi(3, 2)) + _ld(3, _vi(3, 1))


def _png_b64(rng, size) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8)
                    ).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def vt_eval_data(work: Path):
    """The VT eval's inputs, written under ``work``: an MMBench TSV of the
    VT_QUESTIONS (random PNG images from a seed, base64 as MMBench ships
    them) read by ``MMBenchDataset``, and a SentencePiece model over their
    words loaded by ``load_tokenizer`` (32000 pieces + the 11 multimodal
    tokens = the base's vocab)."""
    from moka_tpu_torch.data.benchmarks import MMBenchDataset
    from moka_tpu_torch.data.datasets import llama2_chat_prompt
    from moka_tpu_torch.data.tokenizer import load_tokenizer
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(15)
    rows = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\timage"]
    for i, (q, opts, ans, hint, size) in enumerate(VT_QUESTIONS):
        rows.append("\t".join([str(i), q, hint or "", *opts, ans,
                               _png_b64(rng, size)]))
    (work / "mmbench.tsv").write_text("\n".join(rows) + "\n")
    ds = MMBenchDataset(str(work / "mmbench.tsv"))
    text = " ".join(llama2_chat_prompt(ds[i]["prompt"])
                    for i in range(len(ds)))
    (work / "tokenizer.model").write_bytes(sp_model_bytes(
        sorted(set(re.findall(r"[A-Za-z]+", text)))))
    return ds, load_tokenizer(str(work / "tokenizer.model"))


def text_batch(items, tokenize) -> dict:
    """``build_eval_batch``'s layout for prompts without an image (no
    ``pixel_values``, no image positions)."""
    from moka_tpu_torch.data import assembler as asm
    from moka_tpu_torch.data.datasets import llama2_chat_prompt
    samples = []
    for it in items:
        ids = np.asarray(tokenize.encode(llama2_chat_prompt(it["prompt"])))
        samples.append(asm.assemble_sample(
            ids, np.full(len(ids), -100), tokenize.token_to_id,
            tokenize.pad_id))
    b = asm.pad_batch(samples, tokenize.pad_id)
    return {"ids": b["ids"], "attn_mask": b["attn_mask"],
            "text_mask": b["modality_masks"][0],
            "image_mask": b["modality_masks"][1],
            "question_mask": b["question_mask"]}


def vt_prefill_checks(records, vcfg, batch, new_tokens) -> None:
    """Kernels 1 and 5 at the exact shape of the VT eval's prefill (its b
    and L, its own left pads, its text and image masks), on random q/k/v,
    x, A and B, against their plain versions under phase 3's limits;
    kernel 5 at every rank it takes, on the batch's question mask (empty:
    the MMBench prompts mark no question) and on one over the prompt's text
    after the image; the records' max_abs_err take the larger error."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    cfg, spec = vcfg.llama, vcfg.spec
    pmask = batch["attn_mask"]
    b, L = pmask.shape
    pads = [int(p) for p in (pmask == 0).sum(dim=1)]
    log(f"  VT prefill batch: b {b} L {L}, left pads {pads}")
    q, k, v, _ = flash_case(b, cfg.n_heads, cfg.n_kv_heads, L,
                            L + new_tokens, seed=15)
    err = check_flash("VT prefill", q, k, v, F.pad(pmask, (0, new_tokens)))
    del q, k, v
    rec = {r["name"]: r for r in records}
    rec["flash_fwd"]["max_abs_err"] = max(rec["flash_fwd"]["max_abs_err"],
                                          err)
    mod = torch.stack([batch["text_mask"], batch["image_mask"]]).float()
    after = torch.arange(L, device="cuda")[None] > batch["image_pos"][:, -1:]
    questions = {"empty": batch["question_mask"].float(),
                 "after the image": (batch["text_mask"] * after).float()}
    g = torch.Generator(device="cuda").manual_seed(22)
    for rank in MOKA_RANKS:
        rspec = dataclasses.replace(spec, rank=rank)
        for d_in, d_out in sorted({(cfg.dim, cfg.dim),
                                   (cfg.dim, cfg.intermediate),
                                   (cfg.intermediate, cfg.dim)}):
            x = torch.randn((b, L, d_in), generator=g,
                            device="cuda").bfloat16()
            bound = 1.0 / math.sqrt(d_in)
            a = torch.rand((2, d_in, rank), generator=g,
                           device="cuda") * 2 * bound - bound
            bm = torch.randn((rank, d_out), generator=g,
                             device="cuda") * 0.02
            for name, qm in questions.items():
                d = check_moka(f"VT prefill r{rank} bf16 {d_in}->{d_out}, "
                               f"question {name}", x, a, bm, mod, qm, rspec)
                rec["moka_delta_fwd"]["max_abs_err"] = max(
                    rec["moka_delta_fwd"]["max_abs_err"], d)


def vt_eval(vcfg, frozen, trainable, records, work: Path) -> tuple:
    """Phase 14 (a): the VT benchmark eval as ``cli/eval_vt.py`` runs it
    (the JAX package's; the port has no CLIs yet) on VT_ITEMS MMBench
    items: ``run_inference(batch_size=8)`` -> ``build_eval_batch`` ->
    ``llava.generate`` (VT_NEW_TOKENS, greedy) -> the rank's JSONL ->
    ``merge_rank_files`` and ``score_option_file``.  First kernels 1 and 5
    at its prefill shape (``vt_prefill_checks``), the prefill logits under
    phase 4's rule (``check_logits``), the CLIP pass and the projector
    timed, and ``generate`` for 1 and VT_NEW_TOKENS tokens (``main_path``:
    32 + 23 flash forward launches, 23 at head_dim 64, and 224 fused MokA
    a call).  Returns (results, the tokenizer)."""
    import torch
    from moka_tpu_torch.data.benchmarks import build_eval_batch
    from moka_tpu_torch.eval.runner import run_inference
    from moka_tpu_torch.eval.scorers import options
    from moka_tpu_torch.models import llava
    from moka_tpu_torch.models.clip_vit import clip_hidden_states
    from moka_tpu_torch.models.projectors import project_visual
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    ds, tok = vt_eval_data(work)
    log(f"  MMBench TSV of {len(ds)} items and a {tok.vocab_size}-token "
        f"SentencePiece tokenizer written and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    if tok.vocab_size != vcfg.llama.vocab_size:
        raise AssertionError(f"tokenizer vocab {tok.vocab_size}")
    nq, n, sel = vcfg.projector.num_query_tokens, vcfg.llama.n_layers, \
        vcfg.select_layer
    tokenize = tok.as_tokenize()
    batch = to_card(build_eval_batch([ds[i] for i in range(len(ds))],
                                     tokenize, nq))
    vt_prefill_checks(records, vcfg, batch, VT_NEW_TOKENS)
    with torch.inference_mode():
        embeds = llava.build_inputs_embeds(trainable, frozen, vcfg, batch)
    check_logits(vcfg.llama, vcfg.spec, frozen["llama"],
                 trainable["adapters"],
                 {"inputs_embeds": embeds, "prompt_mask": batch["attn_mask"],
                  "masks": llava._masks(batch)}, VT_NEW_TOKENS)
    del embeds
    pixels = batch["pixel_values"].to(torch.bfloat16)
    with torch.inference_mode():
        feats = clip_hidden_states(frozen["clip"], vcfg.clip, pixels,
                                   (sel,))[0].float()
        few = dict(iters=3, warmup=1)
        stages = {"clip_ms": time_ms(lambda: clip_hidden_states(
                      frozen["clip"], vcfg.clip, pixels, (sel,)), **few),
                  "projector_ms": time_ms(lambda: project_visual(
                      trainable["projector"], vcfg.projector, feats), **few)}
    log(f"  CLIP pass {stages['clip_ms']:.2f} ms, projector "
        f"{stages['projector_ms']:.2f} ms (b {pixels.shape[0]})")
    want = _launches(flash_fwd=n + sel, flash_fwd_hd64=sel,
                     moka_delta_fwd=7 * n, **decode_launches(
                         vcfg.llama, batch["attn_mask"].shape[1] +
                         VT_NEW_TOKENS, VT_NEW_TOKENS))
    timed = main_path(lambda k: llava.generate(
        trainable, frozen, vcfg, batch, max_new_tokens=k, eos_id=-1),
        len(ds), VT_NEW_TOKENS, vcfg.llama.vocab_size, want,
        f"llava.generate b {len(ds)}")
    timed["encoder_inclusive_tok_s"] = len(ds) * VT_NEW_TOKENS / (
        timed["total_ms"] / 1e3)
    log(f"  encoder-inclusive {timed['encoder_inclusive_tok_s']:.1f} new "
        f"tokens/s")

    def generate_fn(items):
        eval_batch = to_card(build_eval_batch(items, tokenize, nq))
        toks = llava.generate(trainable, frozen, vcfg, eval_batch,
                              max_new_tokens=VT_NEW_TOKENS,
                              eos_id=tok.eos_id, pad_id=tok.pad_id)
        return [{**it["meta"], "answer": it["answer"],
                 "output": [tok.decode([x for x in t if x != tok.pad_id])]}
                for it, t in zip(items, toks.tolist())]

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    shard = run_inference(ds, generate_fn, str(work / "out"), "mmbench",
                          batch_size=VT_ITEMS)
    eval_s = time.perf_counter() - t0
    launches = _counts()
    scores = options.score_option_file(
        options.merge_rank_files(str(work / "out")))
    rows = [json.loads(x) for x in open(shard)]
    log(f"  run_inference: {len(rows)} rows in {eval_s:.2f} s, first "
        f"output {rows[0]['output'][0][:60]!r}; scores {scores}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want or scores["total"] != len(ds) or \
            len(rows) != len(ds) or not all(
                isinstance(r["output"][0], str) and r["answer"] in "ABCD"
                for r in rows):
        raise AssertionError(f"VT eval: launches {launches}, want {want}, "
                             f"scores {scores}")
    return {**timed, **stages, "eval_s": eval_s, "eval_launches": launches,
            "scores": scores}, tok


def vt_serve(vcfg, frozen, trainable, tok) -> dict:
    """Phase 14 (b): the micro-batch HTTP front (``serve``) over
    ``llava.generate``: one /generate request with a base64 PNG (decoded by
    the front's image branch) and one without, posted together; both must
    answer 200 with generated text, the image through the tower (23
    kernel-1c launches) and each prompt through one generate call."""
    import torch
    from moka_tpu_torch.data.benchmarks import IMAGE_HEADER, build_eval_batch
    from moka_tpu_torch.eval.server import serve
    from moka_tpu_torch.models import llava
    nq, tokenize = vcfg.projector.num_query_tokens, tok.as_tokenize()
    decode = {}  # the decode kernel's launches of the generate calls

    def generate_fn(items):
        out = [None] * len(items)
        for with_image in (True, False):
            idx = [i for i, it in enumerate(items)
                   if ("image" in it) == with_image]
            if not idx:
                continue
            group = [items[i] for i in idx]
            batch = build_eval_batch(group, tokenize, nq) if with_image \
                else text_batch(group, tokenize)
            for k, v in decode_launches(
                    vcfg.llama, batch["attn_mask"].shape[1] + VT_NEW_TOKENS,
                    VT_NEW_TOKENS).items():
                decode[k] = decode.get(k, 0) + v
            toks = llava.generate(trainable, frozen, vcfg, to_card(batch),
                                  max_new_tokens=VT_NEW_TOKENS, eos_id=-1,
                                  pad_id=tok.pad_id)
            for i, t in zip(idx, toks.tolist()):
                out[i] = tok.decode([x for x in t if x != tok.pad_id])
        return out

    server = serve(generate_fn, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    image = _png_b64(np.random.default_rng(16), (320, 240))
    bodies = {"image": {"prompt": IMAGE_HEADER + "What is in the picture?",
                        "image": image},
              "text": {"prompt": "Name a color of the sky."}}
    answers: dict = {}

    def post(name):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(bodies[name]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            answers[name] = (resp.status, json.loads(resp.read())["output"])

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(k,)) for k in bodies]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
        thread.join(timeout=10)
    wall = time.perf_counter() - t0
    launches = _counts()
    n, sel = vcfg.llama.n_layers, vcfg.select_layer
    want = _launches(flash_fwd=2 * n + sel, flash_fwd_hd64=sel,
                     moka_delta_fwd=2 * 7 * n, **decode)
    log(f"  HTTP front: {len(answers)} requests in {wall:.2f} s: "
        f"{ {k: (s, o[:40]) for k, (s, o) in answers.items()} }; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if any(t.is_alive() for t in threads) or sorted(answers) != \
            sorted(bodies) or any(
                s != 200 or not o or o.startswith("ERROR")
                for s, o in answers.values()) or launches != want:
        raise AssertionError(f"VT HTTP front: {answers}, launches "
                             f"{launches}, want {want}")
    return {"wall_s": wall, "launches": launches,
            "status": {k: s for k, (s, _) in answers.items()}}


def vt_train_batch(vcfg, b, L) -> dict:
    """``bench.py::run_vt``'s batch (:474-491): a prefix, 32 image
    placeholders, a 32-token question and an answer filling each sample to
    about L, right-padded to L with shared positions, and random pixels;
    on the card."""
    from moka_tpu_torch.data.vt_dataset import build_vt_sample, collate_vt
    nq = vcfg.projector.num_query_tokens
    ph, pad = vcfg.llama.vocab_size - 1, 0
    rng = np.random.default_rng(0)
    samples = []
    for i in range(b):
        pre = rng.integers(4, 1000, 16 + i).tolist()
        q = rng.integers(4, 1000, 32).tolist()
        ans = rng.integers(4, 1000, L - (len(pre) + nq + len(q)) - 8 -
                           i).tolist()
        ids = np.asarray(pre + [ph] * nq + q + ans)
        labels = np.asarray([-100] * (len(pre) + nq + len(q)) + ans)
        samples.append(build_vt_sample(ids, labels, ph, pad,
                                       num_image_tokens=nq))
    batch = collate_vt(samples, pad_id=pad, pad_to=L)
    img = vcfg.clip.image_size
    batch["pixel_values"] = rng.standard_normal(
        (b, 3, img, img)).astype(np.float32)
    return to_card(batch)


def vt_loss(vcfg, kernels: bool):
    """The VT step's loss (VT_LOSS): through the flash kernels (the
    decoder and the CLIP tower), or on the plain path (eager attention in
    both)."""
    import dataclasses
    from moka_tpu_torch.models.llava import llava_loss
    if not kernels:
        vcfg = dataclasses.replace(vcfg, clip=dataclasses.replace(
            vcfg.clip, use_flash=False))
    return llava_loss(vcfg, use_flash=kernels, **VT_LOSS)


def vt_steps(vcfg, frozen, trainable) -> dict:
    """Phase 14 (c): the VT fine-tune step ``vt_7b_int4a8f_qh_qenc_sq8plse``
    (b 4 x L 1024, VT_LOSS, ``make_optimizer(TrainConfig(), 1000)``, the
    trainable tree {adapters, projector}): the SHALLOW gradient check
    (phase 13's rule), then at full depth 2 warm-up and 2 timed steps;
    launches a step asserted (32 + 23 flash forward, 23 at head_dim 64,
    32 fused backward)."""
    import torch
    batch = vt_train_batch(vcfg, 4, 1024)
    check = check_mm_grads(vcfg, frozen, trainable, batch, loss_for=vt_loss,
                           what="VT step")
    run = train_steps(vcfg.llama, vcfg.spec, frozen, clone_tree(trainable),
                      batch, loss_fn=vt_loss(vcfg, True))
    n, sel = vcfg.llama.n_layers, vcfg.select_layer
    want = _launches(flash_fwd=n + sel, flash_fwd_hd64=sel,
                     flash_bwd_fused=n)
    log(f"  step min {run['step_ms_min']:.1f} ms, median "
        f"{run['step_ms']:.1f} ms, {run['tokens_per_s']:.1f} tokens/s, peak "
        f"memory {run['peak_memory_bytes'] / 2**30:.2f} GiB")
    if run["launches_per_step"] != want:
        raise AssertionError(f"VT step launches {run['launches_per_step']}, "
                             f"want {want}")
    if not run["losses"][-1] < run["losses"][0]:
        raise AssertionError(f"the loss did not fall: {run['losses']}")
    torch.cuda.empty_cache()
    return {"check": check, **run}


# ----------------------------------------------------------------- phase 15

P15_SEED = 15
P15_SAMPLES = 12   # AVQA samples and LLaVA-Instruct rows: 3 steps at b 4
P15_PRETRAIN_IMAGES = 8  # 2 pretraining steps at b 4
P15_SHARDS = 4     # the LLaMA checkpoint's shards
P15_MARGIN = 8 * 2**30  # bytes of disk beyond the LLaMA checkpoint at 7B:
                   # CLIP and BEATs, the trainers' checkpoints (3 kept,
                   # 1.83 GiB each for finetune's 164 M fp32 parameters
                   # with AdamW's moments) and the artifacts
P15_QUESTIONS = (  # AVQA question, answer
    ("How many instruments are sounding in the video?", "two"),
    ("Is the violin louder than the piano?", "yes"),
    ("Which instrument starts playing first?", "guitar"),
    ("Where is the loudest instrument?", "left"))
P15_CAPTIONS = ("A red square on a gray wall.", "Two birds over the sea.",
                "A bowl of fruit on a table.", "A street at night.")
RESUME_TOL = 0.0   # the restored step-2 state against the uninterrupted
                   # run's step 3: the step's forward (kernel 1, the eager
                   # towers, the chunked CE, cuBLAS and _int_mm) sums in a
                   # fixed order and the state is restored bit for bit


def p15_configs(tiny: bool):
    """The LLaMA, CLIP and BEATs configs of the checkpoint files: what the
    CLIs build at ``--model-preset 7b`` (LLaMA-2-7B at vocab 32011, CLIP
    ViT-L/14, the BEATs_iter3+ config), or at ``tiny``."""
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.models.beats import BeatsConfig
    from moka_tpu_torch.models.clip_vit import ClipVitConfig
    vocab = SP_PIECES + 11
    if tiny:
        return (LlamaConfig.tiny(vocab_size=vocab), ClipVitConfig.tiny(),
                BeatsConfig.tiny())
    return (LlamaConfig.llama2_7b(vocab_size=vocab),
            ClipVitConfig.vit_l_14(), BeatsConfig())


def _bf16_values(tree, keep: tuple):
    """A bf16 tree with the leaves not named in ``keep`` widened to fp32:
    the dtypes the importers give, and values a bf16 file holds exactly."""
    import torch
    return {k: (v if k in keep or v is None else
                _bf16_values(v, ()) if isinstance(v, dict) else
                v.to(torch.float32)) for k, v in tree.items()}


def p15_sources(lcfg, ccfg, bcfg, device):
    """The trees the checkpoint files are written from, random from
    P15_SEED on ``device``: LLaMA in bf16; CLIP and BEATs with the leaves
    their importers keep in ``dtype`` in bf16 and the others fp32 holding
    bf16 values."""
    import torch
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.models.beats import init_beats_params
    from moka_tpu_torch.models.clip_vit import init_clip_params
    g = torch.Generator(device=device).manual_seed(P15_SEED)
    kw = dict(device=device, dtype=torch.bfloat16)
    base = llama.init_llama_params(g, lcfg, **kw)
    clip = _bf16_values(init_clip_params(g, ccfg, **kw), ("cls", "patch",
                                                          "pos"))
    beats = _bf16_values(init_beats_params(g, bcfg, **kw),
                         ("patch", "patch_bias", "pos_conv_w", "pos_conv_b",
                          "rel_bias"))
    return base, clip, beats


def llama_hf_state_dict(base: dict, layers: range) -> dict:
    """HF LlamaForCausalLM names for ``layers`` of a layer-stacked tree
    (the inverse of ``import_llama``), CPU tensors in the tree's dtype;
    the embeddings with the first layer, the norm and head with the
    last."""
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj", "attn_norm": "input_layernorm",
             "mlp_norm": "post_attention_layernorm"}
    sd = {}
    for i in layers:
        for ours, theirs in names.items():
            w = base["layers"][ours][i]
            sd[f"model.layers.{i}.{theirs}.weight"] = \
                (w.t() if w.dim() == 2 else w).contiguous().cpu()
    if layers[0] == 0:
        sd["model.embed_tokens.weight"] = base["embed"].contiguous().cpu()
    if layers[-1] == len(base["layers"]["q"]) - 1:
        sd["model.norm.weight"] = base["final_norm"].cpu()
        sd["lm_head.weight"] = base["lm_head"].t().contiguous().cpu()
    return sd


def beats_hf_state_dict(tree: dict, cfg) -> tuple[dict, dict]:
    """A BEATs checkpoint ``(model, cfg)`` (the inverse of
    ``import_beats``): bf16 tensors, the positional convolution split into
    weight_v (the tree's kernel) and an fp32 weight_g (its norm over all
    but dim 2), which ``fold_weight_norm`` folds back to the kernel to
    within an fp32 rounding: exact once cast to bf16."""
    import torch
    bf = torch.bfloat16

    def t(x):
        return x.detach().to(dtype=bf).contiguous().cpu()

    e = tree["patch"].shape[1]
    p = cfg.input_patch_size
    v = tree["pos_conv_w"].float().cpu().numpy()
    sd = {"patch_embedding.weight": t(tree["patch"].t().reshape(e, 1, p, p)),
          "layer_norm.weight": t(tree["frontend_ln"]["g"]),
          "layer_norm.bias": t(tree["frontend_ln"]["b"]),
          "post_extract_proj.weight": t(tree["post_proj"]["w"].t()),
          "post_extract_proj.bias": t(tree["post_proj"]["b"]),
          "encoder.pos_conv.0.weight_v": t(tree["pos_conv_w"]),
          "encoder.pos_conv.0.weight_g": torch.from_numpy(
              np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))),
          "encoder.pos_conv.0.bias": t(tree["pos_conv_b"]),
          "encoder.layer_norm.weight": t(tree["encoder_ln"]["g"]),
          "encoder.layer_norm.bias": t(tree["encoder_ln"]["b"]),
          "encoder.layers.0.self_attn.relative_attention_bias.weight":
              t(tree["rel_bias"])}
    if tree["patch_bias"] is not None:
        sd["patch_embedding.bias"] = t(tree["patch_bias"])
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "ln_attn": "self_attn_layer_norm", "fc1": "fc1", "fc2": "fc2",
             "ln_final": "final_layer_norm",
             "grep": "self_attn.grep_linear"}
    lay = tree["layers"]
    for i in range(cfg.encoder_layers):
        q = f"encoder.layers.{i}."
        for ours, theirs in names.items():
            leaf = lay[ours]
            w = leaf["g"][i] if "g" in leaf else leaf["w"][i].t()
            sd[f"{q}{theirs}.weight"] = t(w)
            sd[f"{q}{theirs}.bias"] = t(leaf["b"][i])
        sd[f"{q}self_attn.grep_a"] = t(lay["grep_a"][i].reshape(
            1, cfg.encoder_heads, 1, 1))
    flags = {"input_patch_size": p, "embed_dim": cfg.embed_dim,
             "encoder_embed_dim": cfg.encoder_embed_dim,
             "encoder_layers": cfg.encoder_layers,
             "encoder_ffn_embed_dim": cfg.encoder_ffn_dim,
             "encoder_attention_heads": cfg.encoder_heads,
             "conv_bias": cfg.conv_bias, "deep_norm": cfg.deep_norm,
             "layer_norm_first": cfg.layer_norm_first,
             "relative_position_embedding": cfg.relative_position_embedding,
             "num_buckets": cfg.num_buckets,
             "max_distance": cfg.max_distance,
             "gru_rel_pos": cfg.gru_rel_pos, "conv_pos": cfg.conv_pos,
             "conv_pos_groups": cfg.conv_pos_groups}
    return sd, flags


def checkpoint_format() -> str:
    """safetensors where it imports, else torch ``.bin`` shards."""
    try:
        import safetensors.torch  # noqa: F401
        return "safetensors"
    except ImportError:
        return "bin"


def _write_sd(sd: dict, path_stem: Path, fmt: str) -> Path:
    import torch
    if fmt == "safetensors":
        from safetensors.torch import save_file
        path = path_stem.with_name(path_stem.name + ".safetensors")
        save_file(sd, str(path))
    else:
        path = path_stem.with_name(path_stem.name + ".bin")
        torch.save(sd, path)
    return path


def write_checkpoints(work: Path, sources, cfgs, fmt: str) -> dict:
    """The three checkpoints under ``work``: LLaMA as P15_SHARDS shards
    (HF names: ``model-0000k-of-0000n`` or ``pytorch_model-0000k-of-...``),
    CLIP in HF CLIPVisionModel names (``clip_to_torch_state_dict``, bf16)
    and BEATs as a ``{cfg, model}`` ``.pt``."""
    import torch
    from moka_tpu_torch.train.checkpoint import clip_to_torch_state_dict
    base, clip, beats = sources
    lcfg, ccfg, bcfg = cfgs
    llama_dir = work / "llama"
    llama_dir.mkdir(parents=True, exist_ok=True)
    n = lcfg.n_layers
    cuts = np.linspace(0, n, min(P15_SHARDS, n) + 1).astype(int)
    stem = "model" if fmt == "safetensors" else "pytorch_model"
    for k, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]), 1):
        _write_sd(llama_hf_state_dict(base, range(a, b)),
                  llama_dir / f"{stem}-{k:05d}-of-{len(cuts) - 1:05d}", fmt)
    clip_sd = {k: v.to(torch.bfloat16) for k, v in
               clip_to_torch_state_dict(clip, ccfg).items()}
    clip_path = _write_sd(clip_sd, work / "clip", fmt)
    sd, flags = beats_hf_state_dict(beats, bcfg)
    torch.save({"cfg": flags, "model": sd}, work / "beats.pt")
    return {"llama": llama_dir, "clip": clip_path, "beats": work / "beats.pt"}


def _tree_equal(got, want, what: str) -> None:
    import torch
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{what}: keys differ")
        for k in want:
            _tree_equal(got[k], want[k], f"{what}/{k}")
        return
    if want is None or got is None:
        if got is not want:
            raise AssertionError(f"{what}: {got} != {want}")
        return
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"{what}: differs from the source tree "
                             f"({got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)})")


def check_importers(paths: dict, sources, cfgs, device) -> dict:
    """Every importer on the files against the tree they were written
    from, exactly; ``import_llama_quantized``'s codes against
    ``quantize_llama_base`` of the source (int4, int8 head)."""
    import torch
    from moka_tpu_torch.ops.quant import (import_llama_quantized,
                                          quantize_llama_base)
    from moka_tpu_torch.train import import_torch as imp
    base, clip, beats = sources
    lcfg, ccfg, bcfg = cfgs
    out = {}
    t0 = time.perf_counter()
    sd = imp.load_torch(str(paths["llama"]))
    out["llama_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _tree_equal(imp.import_llama(sd, lcfg, device=device), base, "llama")
    out["llama_import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = import_llama_quantized(sd, lcfg, bits=4, head_bits=8, device=device)
    _sync(device)
    out["llama_import_quantized_s"] = time.perf_counter() - t0
    _tree_equal(q, quantize_llama_base(base, bits=4, head_bits=8),
                "llama int4 (int8 head)")
    del sd, q
    t0 = time.perf_counter()
    _tree_equal(imp.import_clip(imp.load_torch(str(paths["clip"])), ccfg,
                                dtype=torch.bfloat16, device=device),
                clip, "clip")
    out["clip_read_import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsd, flags = imp.load_torch(str(paths["beats"]))
    bc = imp.beats_config_from_ckpt(flags)
    if bc != bcfg:
        raise AssertionError(f"BEATs config {bc} != {bcfg}")
    _tree_equal(imp.import_beats(bsd, bc, dtype=torch.bfloat16,
                                 device=device), beats, "beats")
    out["beats_read_import_s"] = time.perf_counter() - t0
    return out


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def p15_data(work: Path, image_size: int, n_frames: int):
    """The CLIs' inputs under ``work``: P15_SAMPLES AVQA samples (a cv2
    MJPG ``.avi`` of ``n_frames`` frames and a 60 s 16 kHz ``.wav`` each),
    as many LLaVA-Instruct rows over seeded PNGs, a caption JSON over the
    first P15_PRETRAIN_IMAGES of them, and a SentencePiece model (phase
    14's 32000 pieces, over every word the three CLIs tokenize)."""
    import cv2
    from PIL import Image
    from scipy.io import wavfile
    from moka_tpu_torch.data.datasets import (AVQA_INSTRUCTION,
                                              PRETRAIN_IMAGE_PROMPT,
                                              llama2_chat_prompt)
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(P15_SEED)
    text, ann, rows, caps = [], [], [], []
    for i in range(P15_SAMPLES):
        q, a = P15_QUESTIONS[i % len(P15_QUESTIONS)]
        vid, wav = work / f"v{i}.avi", work / f"a{i}.wav"
        w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 5,
                            (64, 64))
        for _ in range(n_frames):
            w.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
        w.release()
        wavfile.write(wav, 16000, (rng.standard_normal(16000 * 60) *
                                   3000).astype(np.int16))
        ann.append({"video_id": f"v{i}", "question_id": i,
                    "type": ["Audio", "Counting"], "video_path": str(vid),
                    "audio_path": str(wav), "question": q, "answer": a,
                    "label": f"<answer> {a} </answer>"})
        text += [llama2_chat_prompt(AVQA_INSTRUCTION.format(question=q)), a]
        png = f"img{i}.png"
        size = (image_size + 16 * (i % 3), image_size + 8 * (i % 2))
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3),
                                     np.uint8)).save(work / png)
        user = f"<image>\n{q}"
        rows.append({"image": png, "conversations": [
            {"from": "human", "value": user}, {"from": "gpt", "value": a}]})
        text += [llama2_chat_prompt(user), a]
        if i < P15_PRETRAIN_IMAGES:
            cap = P15_CAPTIONS[i % len(P15_CAPTIONS)]
            caps.append({"image": str(work / png), "caption": cap})
            text += [llama2_chat_prompt(PRETRAIN_IMAGE_PROMPT), cap]
    (work / "avqa.json").write_text(json.dumps(ann))
    (work / "llava_instruct.json").write_text(json.dumps(rows))
    (work / "captions.json").write_text(json.dumps(caps))
    (work / "tokenizer.model").write_bytes(sp_model_bytes(
        sorted(set(re.findall(r"[A-Za-z]+", " ".join(text))))))
    return {"avqa": work / "avqa.json", "vt": work / "llava_instruct.json",
            "captions": work / "captions.json",
            "tokenizer": work / "tokenizer.model", "images": work}


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_cli(main_fn, argv: list, device: str, steps_before: int = 0
            ) -> tuple:
    """One CLI ``main(argv)`` with the launch counts zeroed before and read
    after, the wall, the peak device memory, its stdout (kept), the
    ``[... ready in X s]`` import seconds, and the step times of this
    invocation from ``metrics.jsonl`` less each preceding checkpoint
    save (timed by wrapping ``checkpoint.save``).  -> (trainer, batches,
    record)."""
    import torch
    from moka_tpu_torch.train import checkpoint as ckpt
    on_card = torch.device(device).type == "cuda"
    saves: dict = {}
    real_save = ckpt.save

    def timed_save(directory, state, *a, **k):
        t = time.perf_counter()
        real_save(directory, state, *a, **k)
        saves[int(state.step)] = time.perf_counter() - t

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tee = _Tee(sys.stdout)
    ckpt.save = timed_save
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            trainer, batches = main_fn(argv)
        _sync(device)
    finally:
        ckpt.save = real_save
    wall = time.perf_counter() - t0
    launches = _counts()
    text = tee.buf.getvalue()
    ready = re.search(r"ready in ([0-9.]+) s", text)
    out = Path(argv[argv.index("--output-dir") + 1])
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if r["step"] > steps_before and "loss" in r]
    step_s = [r["step_time_s"] - saves.get(r["step"] - 1, 0.0)
              for r in rows]
    steps = len(rows)
    per_step = {k: v // max(steps, 1) for k, v in launches.items()}
    if any(v % max(steps, 1) for v in launches.values()):
        raise AssertionError(f"launches {launches} not a multiple of "
                             f"{steps} steps")
    batch = int(argv[argv.index("--global-batch") + 1])
    pad_to = int(argv[argv.index("--pad-to") + 1])
    median = float(np.median(step_s[1:])) if steps > 1 else float("nan")
    rec = {"wall_s": wall, "import_s": float(ready.group(1)) if ready else
           None, "steps": steps, "losses": [r["loss"] for r in rows],
           "step_ms": [s * 1e3 for s in step_s],
           "step_ms_median": median * 1e3,
           "save_ms": {k: v * 1e3 for k, v in saves.items()},
           "tokens_per_s": batch * pad_to / median,
           "supervised_tokens_per_s": float(np.median(
               [r["supervised_tokens"] for r in rows[1:]] or [0])) / median,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()
           if on_card else 0,
           "launches_per_step": per_step, "stdout": text}
    return trainer, batches, rec


def _log_cli(name: str, rec: dict, smi: str) -> None:
    log(f"  {name}: wall {rec['wall_s']:.1f} s, checkpoint read + import "
        f"(+ quantize) {rec['import_s']:.2f} s, {rec['steps']} steps, "
        f"step median {rec['step_ms_median']:.1f} ms (first excluded, "
        f"checkpoint saves excluded: "
        f"{ {k: round(v, 1) for k, v in rec['save_ms'].items()} } ms), "
        f"{rec['tokens_per_s']:.1f} tokens/s "
        f"({rec['supervised_tokens_per_s']:.1f} supervised), peak "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
        f"{[round(x, 4) for x in rec['losses']]}; {smi}")
    log(f"    launches a step: "
        f"{ {k: v for k, v in rec['launches_per_step'].items() if v} }")


def flash_per_step(n_layers: int, policy: str | None, flash: bool,
                   device: str) -> dict:
    """Kernels 1 and 2 a training step, from the config: one flash
    forward a layer when the remat policy keeps the flash residuals (out,
    lse), else two (the recompute reruns it); one fused backward a layer
    (L <= 1024); none without flash or off the card."""
    from moka_tpu_torch.models.llama import REMAT_POLICIES
    if not flash or device != "cuda":
        return _launches()
    keeps = {"flash_out", "flash_lse"} <= set(REMAT_POLICIES[policy])
    return _launches(flash_fwd=n_layers * (1 if keeps else 2),
                     flash_bwd_fused=n_layers)


def resume_parity(trainer, batches, out: Path, step: int) -> dict:
    """Phase 15 (c): the checkpoint of ``step`` restored into a fresh
    ``TrainState`` (the trainer's optimizer, a new trainable template),
    one step on the run's batch ``step + 1``; its loss against the
    uninterrupted run's logged loss of step ``step + 1``."""
    import itertools
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train import checkpoint as ckpt
    from moka_tpu_torch.train.optim import tree_map
    from moka_tpu_torch.train.step import init_train_state
    template = init_train_state(tree_map(torch.empty_like,
                                         trainer.state.params),
                                trainer.tx, DropoutKey(0))
    state = ckpt.restore(str(out / "checkpoints"), template, step=step)
    if state.step != step:
        raise AssertionError(f"restored step {state.step}, want {step}")
    batch = next(itertools.islice(batches(), step, None))
    _, metrics = trainer.step_fn(state, trainer.frozen, batch)
    loss = float(metrics["loss"])
    want = next(json.loads(line)["loss"] for line in
                (out / "metrics.jsonl").read_text().splitlines()
                if json.loads(line)["step"] == step + 1)
    diff = abs(loss - want)
    log(f"  (c) resume parity: step-{step} checkpoint restored, one step on "
        f"batch {step + 1}: loss {loss!r} vs the uninterrupted {want!r}, "
        f"|difference| {diff!r} (tolerance {RESUME_TOL})")
    if not diff <= RESUME_TOL:
        raise AssertionError(f"resumed loss {loss} != {want}")
    return {"loss": loss, "uninterrupted": want, "abs_diff": diff,
            "tolerance": RESUME_TOL}


def _params_equal(got, want, what: str) -> None:
    from moka_tpu_torch.train.optim import tree_map
    _tree_equal(tree_map(lambda t: t.cpu(), got),
                tree_map(lambda t: t.cpu(), want), what)


def p15_summary(res: dict) -> dict:
    """Phase 15's numbers for the log line: no trees, paths or stdout."""
    return {k: ({f: x for f, x in v.items() if f != "stdout"}
                if isinstance(v, dict) else v) for k, v in res.items()
            if not k.endswith(("_params", "_out")) and k != "files"}


def p16_summary(res: dict) -> dict:
    """Phase 16's numbers for the log line: no stdout or paths."""
    return {k: ({f: str(x) if isinstance(x, Path) else x
                 for f, x in v.items() if f != "stdout"}
                if isinstance(v, dict) else v) for k, v in res.items()}


def phase15(work: Path, device: str = "cuda", tiny: bool = False,
            smi: str = "") -> dict:
    """Phase 15: the training life cycle from checkpoint files through the
    three training CLIs' ``main``, at LLaMA-2-7B's full width and depth
    (``tiny``: the CLIs' tiny preset, the rehearsal on the CPU).

    (a) disk checked, LLaMA-2-7B (vocab 32011), CLIP ViT-L/14 and BEATs
    written from P15_SEED in bf16 and read back through every importer
    exactly; (b) ``finetune`` with the shipping AVT flags, 3 steps, a
    checkpoint every step, kernels 1 and 2 a step asserted, then a second
    invocation with one more epoch that resumes from step 3; (c) the
    step-2 checkpoint restored and stepped on batch 3 against the
    uninterrupted step-3 loss; (d) ``train_vt`` with the VT shipping
    flags, 3 steps, ``model.safetensors`` read back exactly; (e)
    ``pretrain --branch visual``, 2 steps, no kernel launched, the stage-1
    artifacts read back exactly."""
    import dataclasses
    import gc
    import torch
    from moka_tpu_torch.cli import finetune, pretrain, train_vt
    from moka_tpu_torch.models import llava, unified
    from moka_tpu_torch.train import import_torch as imp

    cfgs = p15_configs(tiny)
    lcfg, ccfg, bcfg = cfgs
    fmt = checkpoint_format()
    res: dict = {"format": fmt, "device": device}
    # (a)
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    llama_bytes = sum(2 * math.prod(s) for s in (
        (lcfg.vocab_size, lcfg.dim), (lcfg.dim, lcfg.vocab_size))) + \
        2 * lcfg.n_layers * (4 * lcfg.dim * lcfg.dim +
                             3 * lcfg.dim * lcfg.intermediate)
    free = shutil.disk_usage(work).free
    need = llama_bytes + (P15_MARGIN >> 7 if tiny else P15_MARGIN)
    log(f"  (a) disk under {work}: {free / 2**30:.1f} GiB free, "
        f"{need / 2**30:.1f} GiB needed ({llama_bytes / 2**30:.2f} GiB of "
        f"LLaMA checkpoint); format {fmt}")
    if free < need:
        raise RuntimeError(f"phase 15 needs {need / 2**30:.1f} GiB of disk "
                           f"under {work}, {free / 2**30:.1f} GiB free")
    t0 = time.perf_counter()
    sources = p15_sources(lcfg, ccfg, bcfg, device)
    _sync(device)
    res["sources_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = write_checkpoints(work / "ckpt", sources, cfgs, fmt)
    res["write_s"] = time.perf_counter() - t0
    res["file_bytes"] = sum(f.stat().st_size for f in
                            (work / "ckpt").rglob("*") if f.is_file())
    res["importers"] = check_importers(paths, sources, cfgs, device)
    log(f"  checkpoints written in {res['write_s']:.1f} s "
        f"({res['file_bytes'] / 2**30:.2f} GiB); every importer returns "
        f"its source tree exactly: {res['importers']}")
    del sources
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    data = p15_data(work / "data", ccfg.image_size, 2 if tiny else 10)
    preset = "tiny" if tiny else "7b"
    common = ["--llama-ckpt", str(paths["llama"]),
              "--clip-ckpt", str(paths["clip"]),
              "--tokenizer-json", str(data["tokenizer"]),
              "--model-preset", preset, "--global-batch", "4",
              "--device", device]
    quant = ["--quantize-base", "4", "--quantize-head", "8",
             "--quantize-encoders", "8", "--a8-dots", "full"]
    pad = ["--pad-to", "256" if tiny else "1024"]  # tiny: max_seq_len

    # (b) finetune, 3 steps, then (c), then the second invocation
    ft_out = work / "finetune"
    ft_argv = common + quant + pad + [
        "--beats-ckpt", str(paths["beats"]),
        "--avqa-annotation", str(data["avqa"]),
        "--remat-policy", "qkvod_lse", "--save-steps", "1",
        "--output-dir", str(ft_out)]
    want = flash_per_step(lcfg.n_layers, "qkvod_lse", not tiny, device)
    log(f"  (b) finetune {' '.join(ft_argv)} --epochs 1; kernels 1 and 2 a "
        f"step worked out from the config: flash_fwd {want['flash_fwd']}, "
        f"flash_bwd_fused {want['flash_bwd_fused']}")
    trainer, batches, rec = run_cli(finetune.main, ft_argv + ["--epochs",
                                                              "1"], device)
    _log_cli("finetune", rec, smi)
    if rec["launches_per_step"] != want or rec["steps"] != 3:
        raise AssertionError(f"finetune: {rec['steps']} steps, launches a "
                             f"step {rec['launches_per_step']}, want {want}")
    if trainer.state.step != 3:
        raise AssertionError(f"finetune ended at step {trainer.state.step}")
    res["finetune"] = rec
    res["resume_parity"] = resume_parity(trainer, batches, ft_out, 2)
    ft_params = trainer.state.params
    del trainer, batches
    gc.collect()
    trainer, _, rec2 = run_cli(finetune.main, ft_argv + ["--epochs", "2"],
                               device, steps_before=3)
    _log_cli("finetune, second invocation (--epochs 2)", rec2, smi)
    if "[trainer] resumed from step 3" not in rec2["stdout"] or \
            trainer.state.step != 6 or rec2["steps"] != 3 or \
            rec2["launches_per_step"] != want:
        raise AssertionError(f"the second finetune did not resume from "
                             f"step 3 to 6: step {trainer.state.step}, "
                             f"{rec2['steps']} steps, launches "
                             f"{rec2['launches_per_step']}")
    log(f"  second invocation: resumed from step 3, reached step "
        f"{trainer.state.step}")
    res["finetune_resumed"] = rec2
    res["finetune_params"] = ft_params
    res["finetune_resumed_params"] = trainer.state.params
    res["finetune_out"] = ft_out
    del trainer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (d) train_vt
    vt_out = work / "train_vt"
    vt_argv = common + quant + pad + [
        "--save-q8", "--remat-policy", "proj_lse",
        "--data-json", str(data["vt"]), "--image-root", str(data["images"]),
        "--epochs", "1", "--output-dir", str(vt_out)]
    want = flash_per_step(lcfg.n_layers, "proj_lse", not tiny, device)
    log(f"  (d) train_vt {' '.join(vt_argv)}; kernels 1 and 2 a step: "
        f"flash_fwd {want['flash_fwd']}, flash_bwd_fused "
        f"{want['flash_bwd_fused']}")
    trainer, _, rec = run_cli(train_vt.main, vt_argv, device)
    _log_cli("train_vt", rec, smi)
    if rec["launches_per_step"] != want or rec["steps"] != 3:
        raise AssertionError(f"train_vt: {rec['steps']} steps, launches a "
                             f"step {rec['launches_per_step']}, want {want}")
    vcfg = (dataclasses.replace(llava.LlavaConfig.tiny(),
                                llama=lcfg) if tiny else
            llava.LlavaConfig.vt_7b(vocab_size=lcfg.vocab_size))
    back = imp.import_vt_trainable(
        imp.load_torch(str(vt_out / "model.safetensors")), vcfg, {},
        device=device)
    _params_equal(back, trainer.state.params, "model.safetensors")
    log("  model.safetensors read back through import_vt_trainable: the "
        "final params exactly")
    res["train_vt"] = rec
    res["train_vt_params"] = trainer.state.params
    res["train_vt_out"] = vt_out
    del trainer, back
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (e) pretrain, visual branch
    pt_out = work / "pretrain"
    pt_argv = ["--llama-ckpt", str(paths["llama"]),
               "--clip-ckpt", str(paths["clip"]),
               "--tokenizer-json", str(data["tokenizer"]),
               "--image-json", str(data["captions"]), "--branch", "visual",
               "--global-batch", "4", "--pad-to", "512", "--epochs", "1",
               "--output-dir", str(pt_out), "--device", device]
    log(f"  (e) pretrain {' '.join(pt_argv)}: no kernel (its loss passes "
        f"no use_flash)")
    trainer, _, rec = run_cli(pretrain.main, pt_argv, device)
    _log_cli("pretrain", rec, smi)
    if rec["launches_per_step"] != _launches() or rec["steps"] != 2:
        raise AssertionError(f"pretrain: {rec['steps']} steps, launches a "
                             f"step {rec['launches_per_step']}")
    ucfg = unified.UnifiedConfig.avt_7b(vocab_size=lcfg.vocab_size)
    sd = imp.load_torch(str(pt_out / "non_lora_trainables.bin"))
    if not all(k.startswith("model.") for k in sd):
        raise AssertionError("stage-1 keys without the model. prefix")
    for key, kind in (("vl_projector", "visual"), ("al_projector", "audio")):
        back = imp.import_projector(imp.strip_to_submodule(sd, f"{key}."),
                                    getattr(ucfg, key), kind=kind,
                                    device=device)
        _params_equal(back, trainer.state.params[key], key)
    log("  stage-1 non_lora_trainables.bin (model. prefixes) read back "
        "through strip_to_submodule + import_projector: the final params "
        "exactly")
    res["pretrain"] = rec
    res["pretrain_params"] = trainer.state.params
    res["pretrain_out"] = pt_out
    res["files"] = {**{k: Path(v) for k, v in paths.items()},
                    **{f"data_{k}": Path(v) for k, v in data.items()}}
    del trainer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 16

P16_NEW_TOKENS = 32  # new tokens a generate of infer (b 8, 12 AVQA items)
P16_PROMPTS = ("How many instruments are playing?",
               "What is the person doing in the video?",
               "Which instrument is the loudest?")  # the HTTP requests


@contextlib.contextmanager
def per_generate(module, device: str, calls: list):
    """Within: each ``module.generate`` call appends {"launches", "s",
    "args", "kwargs"} to ``calls`` (launch counts zeroed just before the
    call, read just after)."""
    real = module.generate

    def wrapped(*args, **kwargs):
        _sync(device)
        _zero_counts()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        _sync(device)
        calls.append({"launches": _counts(), "s": time.perf_counter() - t0,
                      "args": args, "kwargs": kwargs})
        return out

    module.generate = wrapped
    try:
        yield real
    finally:
        module.generate = real


def run_generating_cli(name: str, main_fn, argv: list, module, device: str,
                       want: dict, new_tokens: int, smi: str) -> dict:
    """An inference CLI's ``main(argv)`` with its stdout kept, its wall and
    peak device memory, and every ``module.generate`` call's launches
    required to equal ``want``; then the first call's batch timed again
    (``main_path``, the CLI's calls its warm-up: 1 and ``new_tokens``
    new tokens, decode = the difference)."""
    import torch
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    calls: list = []
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with per_generate(module, device, calls) as real, \
            contextlib.redirect_stdout(tee):
        result = main_fn(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = [c["launches"] for c in calls if c["launches"] != want]
    log(f"  {name}: wall {wall:.2f} s, {len(calls)} generate calls "
        f"({[round(c['s'], 3) for c in calls]} s), launches a call "
        f"{ {k: v for k, v in calls[0]['launches'].items() if v} }, peak "
        f"{peak / 2**30:.2f} GiB; {smi}")
    if not calls or bad:
        raise AssertionError(f"{name}: launches {bad}, want {want}")
    generate_s = [c["s"] for c in calls]
    args, kwargs = calls[0]["args"], dict(calls[0]["kwargs"], eos_id=-1)
    calls.clear()
    kwargs.pop("generator", None)
    if "temperature" in kwargs:
        kwargs["temperature"] = 0.0
    timed = main_path(
        lambda k: real(*args, **dict(kwargs, max_new_tokens=k)),
        args[3]["attn_mask"].shape[0], new_tokens,
        args[2].llama.vocab_size, want, f"{name}, its first batch again",
        warm=True, prefill_runs=1) if on_card else {}
    return {"wall_s": wall, "peak_memory_bytes": peak, "result": result,
            "generate_s": generate_s, "launches_per_generate": want,
            "stdout": tee.buf.getvalue(), **timed}


def serve_subprocess(argv: list, device: str, prompts=P16_PROMPTS,
                     timeout: float = 600.0) -> dict:
    """``python -m moka_tpu_torch.cli.infer --serve --continuous`` in a
    process of its own (its ``main`` serves until stopped), on an
    OS-chosen port read from its "serving (continuous) on :PORT" line;
    the ``prompts`` posted together to /generate must each answer 200 with
    text; the process is terminated (killed if it lingers) in every
    case."""
    import os
    import queue
    cmd = [sys.executable, "-m", "moka_tpu_torch.cli.infer", *argv,
           "--serve", "--continuous", "--port", "0"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if device != "cuda":
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    out, answers, port = [], {}, None
    try:
        while port is None:
            line = lines.get(timeout=timeout)
            out.append(line)
            m = re.search(r"serving \(continuous\) on :(\d+)", line)
            if m:
                port = int(m.group(1))
            if proc.poll() is not None and lines.empty():
                raise AssertionError("the server exited: " + "".join(out))
        ready_s = time.perf_counter() - t0

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"prompt": prompts[i]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                answers[i] = (resp.status, json.loads(resp.read())["output"])

        t1 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        wall = time.perf_counter() - t1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    log(f"  infer --serve --continuous: ready in {ready_s:.1f} s, "
        f"{len(answers)} requests in {wall:.2f} s: "
        f"{ {i: (st, o[:40]) for i, (st, o) in answers.items()} }")
    if sorted(answers) != list(range(len(prompts))) or any(
            st != 200 or o.startswith("ERROR") for st, o in answers.values()):
        raise AssertionError(f"continuous server answers {answers}: "
                             + "".join(out)[-2000:])
    return {"ready_s": ready_s, "wall_s": wall,
            "statuses": [answers[i][0] for i in range(len(prompts))]}


def phase16(work: Path, p15: dict, device: str = "cuda", tiny: bool = False,
            smi: str = "") -> dict:
    """Phase 16: inference from checkpoint files, inside phase 15's work
    directory, on the LLaMA-2-7B, CLIP and BEATs files phase 15 wrote and
    ``finetune``'s and ``train_vt``'s exported artifacts (``tiny``: the
    CLIs' tiny preset, the rehearsal on the CPU).

    (a) ``infer`` at the shipping serving flags (int4 base, int8 head, b 8,
    P16_NEW_TOKENS new tokens) on phase 15's 12 AVQA items, with the cache
    in bf16 and in int8 (``--kv-quant``): kernel 1, kernel 5 and the
    decode kernel a generate asserted, each JSONL scored by ``score --task
    avqa``, the first batch timed again; (b) ``infer --serve --continuous
    --kv-quant`` answering P16_PROMPTS over HTTP; (c) ``eval_vt`` with
    ``train_vt``'s ``model.safetensors`` on the MMBench items of phase 14
    (its TSV), its scores written; (d) the measurements behind
    ``paged_decode_auto`` on the int4 base ``infer`` imports."""
    import torch
    from moka_tpu_torch.cli import eval_vt, infer, score
    from moka_tpu_torch.models import llava, unified
    files, ft = p15["files"], p15["finetune_out"]
    lcfg = p15_configs(tiny)[0]
    pad_to = 256 if tiny else 1024
    res: dict = {}
    model = ["--llama-ckpt", str(files["llama"]),
             "--clip-ckpt", str(files["clip"]),
             "--model-preset", "tiny" if tiny else "7b",
             "--pad-to", str(pad_to), "--device", device]
    avt = model + ["--tokenizer-json", str(files["data_tokenizer"]),
                   "--beats-ckpt", str(files["beats"]),
                   "--adapter-ckpt", str(ft / "adapter_model.bin"),
                   "--non-lora-ckpt", str(ft / "non_lora_trainables.bin"),
                   "--quantize-base", "4", "--quantize-head", "8",
                   "--max-new-tokens", str(P16_NEW_TOKENS)]
    n = lcfg.n_layers
    for kv_quant in (False, True):
        kind = "int8" if kv_quant else "bf16"
        out = work / f"infer_{kind}"
        argv = avt + ["--annotation", str(files["data_avqa"]),
                      "--batch-size", "8", "--output-dir", str(out)] + \
            (["--kv-quant"] if kv_quant else [])
        want = _launches() if device != "cuda" else _launches(
            flash_fwd=n, moka_delta_fwd=7 * n, **decode_launches(
                lcfg, pad_to + P16_NEW_TOKENS, P16_NEW_TOKENS, kv_quant))
        log(f"  (a) infer {' '.join(argv)}")
        rec = run_generating_cli(f"infer, {kind} cache", infer.main, argv,
                                 unified, device, want, P16_NEW_TOKENS, smi)
        rows = [json.loads(x) for x in Path(rec["result"]).read_text()
                .splitlines()]
        rec["scores"] = score.main(["--task", "avqa", "--path",
                                    str(rec["result"])])
        rec["predictions"] = [r["predict"] for r in rows]
        log(f"  score --task avqa: {rec['scores']}; {len(rows)} rows, first "
            f"prediction {rows[0]['predict'][:60]!r}")
        if len(rows) != P15_SAMPLES or "overall" not in rec["scores"]:
            raise AssertionError(f"infer ({kind}): {len(rows)} rows, scores "
                                 f"{rec['scores']}")
        res[f"infer_{kind}"] = rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    same = [a == b for a, b in zip(res["infer_bf16"]["predictions"],
                                   res["infer_int8"]["predictions"])]
    res["int8_predictions_as_bf16"] = sum(same) / len(same)
    log(f"  the int8 cache's predictions equal the bf16 cache's on "
        f"{sum(same)} of {len(same)} items")

    log("  (b) infer --serve --continuous --kv-quant")
    res["serve"] = serve_subprocess(avt + ["--kv-quant"], device)

    ds, _ = vt_eval_data(work / "mmbench")  # its tokenizer: the same
    vt_out = work / "eval_vt"                # 32011 ids over its words
    argv = model + ["--tokenizer-json",
                    str(work / "mmbench" / "tokenizer.model"),
                    "--task", "mmbench", "--data",
                    str(work / "mmbench" / "mmbench.tsv"),
                    "--model-ckpt", str(p15["train_vt_out"] /
                                        "model.safetensors"),
                    "--batch-size", "8", "--output-dir", str(vt_out)]
    vt_new = eval_vt.MAX_NEW["mmbench"]
    want = _launches() if device != "cuda" else _launches(
        flash_fwd=n, moka_delta_fwd=7 * n, **decode_launches(
            lcfg, pad_to + vt_new, vt_new))
    log(f"  (c) eval_vt {' '.join(argv)}")
    rec = run_generating_cli("eval_vt", eval_vt.main, argv, llava, device,
                             want, vt_new, smi)
    written = json.loads((vt_out / "scores_mmbench.json").read_text())
    log(f"  eval_vt scores {rec['result']}")
    if written != rec["result"] or written["total"] != len(ds):
        raise AssertionError(f"eval_vt scores {written}")
    res["eval_vt"] = rec
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    log("  (d) the decode step, eager against paged (paged_decode_auto's "
        "readings), on the int4 base and adapters infer imports")
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.ops.quant import import_llama_quantized
    from moka_tpu_torch.train import import_torch as imp
    spec = MokaSpec.avt(rank=4, dropout_rate=0.0)
    base = import_llama_quantized(imp.load_torch(str(files["llama"])), lcfg,
                                  bits=4, head_bits=8, device=device)
    adapters = imp.import_moka_adapters_avt(
        imp.load_torch(str(ft / "adapter_model.bin")), lcfg, 3, 4,
        device=device)
    res["paged_gate"] = paged_gate_readings(
        lcfg, spec, base, adapters, device=device,
        capacities=(256,) if tiny else GATE_CAPACITIES,
        steps=1 if tiny else GATE_STEPS, turns=1 if tiny else GATE_TURNS)
    if device == "cuda":
        check_paged_gate(lcfg, res["paged_gate"], device)
    del base, adapters
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------- main

# ----------------------------------------------------------------- phase 17

P17_RANKS = 2  # ranks on the one card: gloo groups (NCCL refuses two ranks
               # on a device), whose collectives move host copies
P17_OFFLOAD_GAP = 10 * 2**30  # the host-streamed step's peak device memory
                              # at least this far below the resident one's
P17_FSDP_LAYERS = 4  # the FSDP / data-parallel steps' depth at 7B widths:
                     # a gloo all-gather of 32 layers a step takes too long
P17_STEPS = (2, 1)  # warm-up and further steps of the mesh step checks
P17_RING_LAYERS = 8  # (b)'s depth: a cut from 32, for the script's time
P17_TINY_STEPS = (1, 1)  # the CPU rehearsal's
RING_DEEP_TOL = (2e-3, 0.25)  # the ring's loss (relative) and adapter
                              # gradients (relative L2, per projection)
                              # against the one-process flash step through
                              # its layers (set at 32, now P17_RING_LAYERS):
                              # each shard's partial output is
                              # rounded to bf16 before the fp32 merge, the
                              # class of difference between the kernels and
                              # the plain attention, whose 32-layer gradients
                              # phase 6 finds 0.15 apart; the tight rule is
                              # phase 6's, at SHALLOW layers against fp32


def p17_configs(tiny: bool):
    """(the ring's long-context config, the streamed / mesh config, spec):
    phase 6-7's LLaMA-2-7B and MokA AVT r4 (dropout 0.05, question window
    256), the ring at P17_RING_LAYERS layers, or ``LlamaConfig.tiny`` for
    the CPU rehearsal."""
    from moka_tpu_torch.core.config import LlamaConfig
    from moka_tpu_torch.ops.moka import MokaSpec
    if not tiny:
        cfg, spec = train_config()
        return dataclasses.replace(train_config(long_context=True)[0],
                                   n_layers=P17_RING_LAYERS), cfg, spec
    cfg = LlamaConfig.tiny(vocab_size=300)
    spec = MokaSpec.avt(rank=4, dropout_rate=0.05).with_question_window(8)
    return dataclasses.replace(cfg, rope_scaling=("dynamic", 2.0)), cfg, spec


def _grads(loss_fn, frozen, trainable, batch, key) -> tuple:
    """(loss, {projection: its adapter gradients of every layer, flat})."""
    import torch
    from moka_tpu_torch.train.optim import tree_leaves
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = loss_fn(trainable, frozen, batch, key)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    flat: dict = {}
    for (name, _), g in zip(sorted((n, ab) for n in PROJS for ab in "ab"),
                            grads):
        flat.setdefault(name, []).append(g.flatten().float())
    return float(loss.detach()), {n: torch.cat(v) for n, v in flat.items()}



def p17_stream(cfg, spec, device: str, tiny: bool, smi: str) -> dict:
    """(a) Phase 6's step (b 4 L 1024, full remat, flash, chunked CE) with
    the base resident, twice (the spread: kernel 2's dq reductions change
    order from run to run), then with the base in pinned host memory
    through ``host_stream``; the streamed loss and gradients within the
    spread, its peak at least P17_OFFLOAD_GAP lower."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.parallel import stream as tstream
    from moka_tpu_torch.parallel.sharding import (shard_params,
                                                  stream_shardings)
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    on_card = device == "cuda"
    b, L = (2, 32) if tiny else (4, 1024)
    frozen, adapters = build_model(cfg, spec, seed=1, device=device)
    trainable = {"adapters": adapters}
    batch = train_batch(cfg, b, L, device=device)
    key = DropoutKey(11)

    def run(base, host_stream=None):
        loss_fn = make_llama_moka_loss(cfg, spec, remat=True,
                                       use_flash=True, fused_loss=True,
                                       ce_chunk=128, host_stream=host_stream)
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        tstream.reset_counts()
        t0 = time.perf_counter()
        loss, grads = _grads(loss_fn, base, trainable, batch, key)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        return {"loss": loss, "grads": grads, "ms": ms,
                "peak": torch.cuda.max_memory_allocated() if on_card else 0,
                "launches": _counts(), "moved": dict(tstream.COUNTS)}

    if on_card:
        run(frozen)  # the process's first step: library loads, allocator
    resident = [run(frozen) for _ in range(2)]
    host = shard_params(None, frozen, host_offload=True)
    whole = sum(nbytes(t) for t in _leaves(frozen))
    layers = sum(nbytes(t) for t in _leaves(frozen["layers"]))
    del frozen
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    pinned = all(t.is_pinned() for t in _leaves(host)) if on_card else False
    streamed = run(host, stream_shardings(None, host))
    spread = {n: rel(resident[1]["grads"][n], resident[0]["grads"][n])
              for n in PROJS}
    res = {"resident_ms": [r["ms"] for r in resident],
           "streamed_ms": streamed["ms"],
           "resident_peak": resident[0]["peak"],
           "streamed_peak": streamed["peak"],
           "loss": {"resident": [r["loss"] for r in resident],
                    "streamed": streamed["loss"]},
           "grad_rel_l2": {n: rel(streamed["grads"][n],
                                  resident[0]["grads"][n]) for n in PROJS},
           "spread_rel_l2": spread, "moved": streamed["moved"],
           "base_bytes": whole, "layer_bytes": layers,
           "launches": streamed["launches"], "pinned": pinned}
    want_bytes = 2 * layers + whole - layers  # layers twice, head, embed, norm
    h2d = streamed["moved"]["h2d_bytes"]
    res["h2d_gb_per_s"] = h2d / streamed["ms"] * 1e-6
    log(f"  (a) resident step {res['resident_ms'][0]:.1f} / "
        f"{res['resident_ms'][1]:.1f} ms, peak "
        f"{res['resident_peak'] / 2**30:.2f} GiB; streamed step "
        f"{res['streamed_ms']:.1f} ms, peak "
        f"{res['streamed_peak'] / 2**30:.2f} GiB (pinned host base "
        f"{pinned}); {streamed['moved']['layer_fetches']} layer fetches, "
        f"{h2d / 1e9:.3f} GB host to device a step ({2 * layers / 1e9:.3f} "
        f"GB of layers, forward and recompute, + head, embed, norm; "
        f"expected {want_bytes / 1e9:.3f}), {res['h2d_gb_per_s']:.2f} GB/s "
        f"over the step; {smi}")
    log(f"  losses resident {res['loss']['resident']}, streamed "
        f"{streamed['loss']}; gradients streamed vs resident rel L2 "
        f"{ {n: f'{v:.2e}' for n, v in res['grad_rel_l2'].items()} }, "
        f"resident vs resident "
        f"{ {n: f'{v:.2e}' for n, v in spread.items()} } (rule, per "
        f"projection: <= {REMAT_NOISE[0]} x that + {REMAT_NOISE[1]})")
    if streamed["moved"]["layer_fetches"] != 2 * cfg.n_layers:
        raise AssertionError(f"host_stream fetched "
                             f"{streamed['moved']['layer_fetches']} layers, "
                             f"want {2 * cfg.n_layers}")
    if on_card and (h2d != want_bytes or not pinned):
        raise AssertionError(f"host_stream moved {h2d} bytes, want "
                             f"{want_bytes} (pinned {pinned})")
    loss_noise = REMAT_NOISE[0] * abs(resident[1]["loss"] -
                                      resident[0]["loss"]) + \
        REMAT_NOISE[1] * abs(resident[0]["loss"])
    if any(not res["grad_rel_l2"][n] <= REMAT_NOISE[0] * spread[n] +
           REMAT_NOISE[1] for n in PROJS) or \
            abs(streamed["loss"] - resident[0]["loss"]) > loss_noise:
        raise AssertionError("the streamed step is not the resident one")
    if streamed["launches"] != resident[0]["launches"]:
        raise AssertionError(f"streamed launches {streamed['launches']} vs "
                             f"{resident[0]['launches']}")
    if on_card and res["resident_peak"] - res["streamed_peak"] < \
            P17_OFFLOAD_GAP:
        raise AssertionError("the streamed peak is not "
                             f"{P17_OFFLOAD_GAP / 2**30:.0f} GiB lower")
    return res


def p17_dropout_rows(device: str, tiny: bool) -> dict:
    """Kernels 6-7 on one rank's rows of a split array (x at 7B width, A of
    AVT r4): the rank's x with its key's ``row_map`` against the same rows
    of the whole array through the kernels (the masks, dx's zeros,
    exactly; out within DROP_TOL of the largest, dx within one bf16 ulp)
    and against the plain versions at the same rows, for the batch
    split (the last of 4 ranks, a sample each) and the sequence split (the
    second of 2 ranks).  Without the row map the rank's mask would be
    another: that is checked too, so the check can see a lost map."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    B, L, d, mr = (4, 32, 64, 12) if tiny else (4, 1024, 4096, 12)
    g = torch.Generator(device=device).manual_seed(19)
    x = torch.randn((B, L, d), generator=g, device=device).to(torch.bfloat16)
    a = torch.randn((d, mr), generator=g, device=device) * 0.02
    gout = torch.randn((B, L, mr), generator=g, device=device)
    key = DropoutKey(23).fold_in(5)
    _zero_counts()
    whole = fd.dropout_a_fwd(x.reshape(-1, d), a, key, DROP_RATE)
    wdx, _ = fd.dropout_a_bwd(x.reshape(-1, d), a, gout.reshape(-1, mr), key,
                              DROP_RATE)
    whole, wdx = whole.reshape(B, L, mr), wdx.reshape(B, L, d)
    out = {}
    for name, (dim, start, size, total) in {
            "batch split": (0, B - 1, 1, B),
            "sequence split": (1, L // 2, L // 2, L)}.items():
        idx = (slice(start, start + size),) if dim == 0 else \
            (slice(None), slice(start, start + size))
        xl = x[idx].reshape(-1, d).contiguous()
        gl = gout[idx].reshape(-1, mr).contiguous()
        rk = key.rows(dim, start, total)
        rows = rk.row_map(x[idx].shape)
        got = fd.dropout_a_fwd(xl, a, rk, DROP_RATE, rows=rows)
        dx, _ = fd.dropout_a_bwd(xl, a, gl, rk, DROP_RATE, rows=rows)
        pout = fd.dropout_a_fwd_plain(xl, a, rk, DROP_RATE, rows=rows)
        pdx, _ = fd.dropout_a_bwd_plain(xl, a, gl, rk, DROP_RATE, rows=rows)
        want, wantdx = whole[idx].reshape(-1, mr), wdx[idx].reshape(-1, d)
        unmapped = fd.dropout_a_bwd_plain(xl, a, gl, key, DROP_RATE)[0]

        def frac(p, q):
            return float((p.float() - q.float()).abs().max() /
                         q.float().abs().max())

        def ulps(p, q):  # > 0: some element beyond one bf16 ulp
            p, q = p.float(), q.float()
            return float(((p - q).abs() - 2 ** -7 * q.abs()).max())

        rec = {"rows": list(rows), "out_vs_whole": frac(got, want),
               "dx_vs_whole": ulps(dx, wantdx),
               "out_vs_plain": frac(got, pout), "dx_vs_plain": ulps(dx, pdx),
               "mask_is_whole": bool(torch.equal(dx != 0, wantdx != 0)),
               "mask_is_plain": bool(torch.equal(dx != 0, pdx != 0)),
               "mask_without_map_differs": not torch.equal(
                   unmapped != 0, pdx != 0)}
        out[name] = rec
        log(f"  dropout kernels at a rank's rows, {name} (row map "
            f"{rows}): x {tuple(xl.shape)} of {(B * L, d)}; out vs the "
            f"whole array's rows {rec['out_vs_whole']:.2e}, vs plain "
            f"{rec['out_vs_plain']:.2e} (tol {DROP_TOL}); dx beyond one ulp "
            f"{rec['dx_vs_whole']:.2e} / {rec['dx_vs_plain']:.2e}; masks = "
            f"whole {rec['mask_is_whole']}, = plain {rec['mask_is_plain']}; "
            f"another mask without the map "
            f"{rec['mask_without_map_differs']}")
        if not (rec["mask_is_whole"] and rec["mask_is_plain"] and
                rec["mask_without_map_differs"] and
                max(rec["out_vs_whole"], rec["out_vs_plain"]) <= DROP_TOL
                and max(rec["dx_vs_whole"], rec["dx_vs_plain"]) <= 0):
            raise AssertionError(f"dropout kernels at a rank's rows, {name}")
    want = _launches(dropout_a_fwd=3, dropout_a_bwd=3) \
        if device == "cuda" else _launches()
    if _counts() != want:
        raise AssertionError(f"row-map launches {_counts()}, want {want}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _rank_log(rank: int, *a) -> None:
    if rank == 0:
        log(*a)


def _seq_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=("seq",))


def p17_ring(rank: int, cfg, spec, device: str, tiny: bool) -> dict:
    """(b) Phase 7's long-context step (b 1, L 4096, dynamic-NTK RoPE,
    full remat, chunked CE) as ``make_llama_moka_loss(context_parallel=
    (mesh, "seq"), use_flash=True)`` over the ranks: loss and adapter
    gradients against rank 0's one-process flash step (RING_DEEP_TOL), the
    launches of kernels 1, 3 and 4 a rank and none of kernel 2; then, at
    SHALLOW layers, the flash ring and the dense ring under phase 6's rule
    (each within TRAIN_RATIO of the one-process flash step's distance from
    an fp32 eager step)."""
    import torch
    import torch.distributed as dist
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    on_card = device == "cuda"
    L = 64 if tiny else 4096
    n = dist.get_world_size()
    frozen, adapters = build_model(cfg, spec, seed=1, device=device)
    trainable = {"adapters": adapters}
    batch = train_batch(cfg, 1, L, seed=2, device=device)
    key = DropoutKey(13)
    mesh = _seq_mesh()

    def loss(c, flash=True, ring=True):
        return make_llama_moka_loss(
            c, spec, remat=True, use_flash=flash, fused_loss=True,
            ce_chunk=128, context_parallel=(mesh, "seq") if ring else None)

    ref = None
    if rank == 0:
        t0 = time.perf_counter()
        ref = _grads(loss(cfg, ring=False), frozen, trainable, batch, key)
        _sync(device)
        ref_ms = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    _sync(device)
    _zero_counts()
    t0 = time.perf_counter()
    got = _grads(loss(cfg), frozen, trainable, batch, key)
    _sync(device)
    ring_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    want = _launches(flash_fwd=2 * n * cfg.n_layers,
                     flash_bwd_dq=n * cfg.n_layers,
                     flash_bwd_dkv=n * cfg.n_layers) if on_card \
        else _launches()
    if counts != want:
        raise AssertionError(f"rank {rank}: ring launches {counts}, want "
                             f"{want}")
    out = {"launches": counts, "ring_ms": ring_ms, "loss": got[0]}
    if rank == 0:
        gap = {p: rel(got[1][p], ref[1][p]) for p in PROJS}
        dloss = abs(got[0] - ref[0]) / abs(ref[0])
        out.update(one_ms=ref_ms, one_loss=ref[0], grad_rel_l2=gap,
                   loss_rel=dloss)
        log(f"  (b) flash ring over {n} ranks, {cfg.n_layers} layers, b 1 L "
            f"{L}: loss {got[0]:.6f} vs one process {ref[0]:.6f} (rel "
            f"{dloss:.2e}); adapter gradients rel L2 "
            f"{ {p: f'{v:.2e}' for p, v in gap.items()} } (tol "
            f"{RING_DEEP_TOL}); {ring_ms:.1f} ms a rank (two ranks share "
            f"the card: no speed figure) vs {ref_ms:.1f} ms in one "
            f"process; launches a rank {counts}")
        if dloss > RING_DEEP_TOL[0] or max(gap.values()) > RING_DEEP_TOL[1]:
            raise AssertionError("the flash ring is not the one-process step")
    # the rehearsal's model has SHALLOW layers: its flash ring and one
    # process at SHALLOW layers are the runs above
    reuse = cfg.n_layers == SHALLOW
    if not reuse:
        del got, ref
        gc.collect()

    # phase 6's rule at SHALLOW layers: the rings against fp32
    sh = dataclasses.replace(cfg, n_layers=SHALLOW)
    fr = first_layers(frozen, SHALLOW)
    tr = {"adapters": first_layers(adapters, SHALLOW)}
    rings = {"flash": got if reuse else _grads(loss(sh), fr, tr, batch, key),
             "dense": _grads(loss(sh, flash=False), fr, tr, batch, key)}
    if rank == 0:
        one = ref if reuse else _grads(loss(sh, ring=False), fr, tr, batch,
                                       key)
        exact = _grads(loss(sh, flash=False, ring=False), float32(fr), tr,
                       batch, key)
        out["shallow"] = {}
        for name, r in rings.items():
            dr, do = abs(r[0] - exact[0]), abs(one[0] - exact[0])
            ok = dr <= TRAIN_RATIO * do + TRAIN_FLOOR * abs(exact[0])
            rec = {"loss": r[0], "one_loss": one[0], "fp32_loss": exact[0],
                   "grad_rel_l2": {}}
            for p in PROJS:
                er, eo = rel(r[1][p], exact[1][p]), rel(one[1][p],
                                                        exact[1][p])
                ok &= er <= TRAIN_RATIO * eo + TRAIN_FLOOR
                rec["grad_rel_l2"][p] = {"ring_vs_fp32": er,
                                         "one_vs_fp32": eo}
            out["shallow"][name] = rec
            log(f"  {name} ring at {SHALLOW} layers: loss {r[0]:.6f}, one "
                f"process {one[0]:.6f}, fp32 {exact[0]:.6f}; gradients rel "
                f"L2 vs fp32 ring / one process "
                f"{ {p: (f'{v['ring_vs_fp32']:.2e}', f'{v['one_vs_fp32']:.2e}') for p, v in rec['grad_rel_l2'].items()} }"
                f" (tol: ring <= {TRAIN_RATIO} x one process + "
                f"{TRAIN_FLOOR})")
            if not ok:
                raise AssertionError(f"the {name} ring fails phase 6's rule")
    del frozen, adapters, trainable, fr, tr, rings
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _mesh_batch(cfg, B: int, L: int, device: str) -> dict:
    """``train_batch`` with every row's supervised count different: row i
    keeps its labels from position L * i / (B + 1) on."""
    batch = train_batch(cfg, B, L, seed=4, device=device)
    for i in range(B):
        batch["labels"][i, : L * i // (B + 1)] = -100
    return batch


def p17_mesh(rank: int, cfg, spec, device: str, tiny: bool) -> dict:
    """(c) ``make_train_step`` on the meshes 1,2,1 (FSDP: each rank holds
    half of every sharded leaf, gathered a layer at a time) and 2,1,1
    (data parallel) at 7B widths and P17_FSDP_LAYERS layers, P17_STEPS
    steps, each rank on its rows of a global batch of 4 x 1024 whose rows
    hold different counts of supervised tokens: losses and adapter updates
    (params - init) against rank 0's one process on the global batch,
    within REMAT_NOISE of the spread of two one-process runs (kernel 2's
    dq reductions change order from run to run, and Adam normalises each
    entry's update, so a small gradient's noise moves it by the learning
    rate).  With random weights every row's CE is about ln(vocab), so this
    rule cannot tell the global count of targets from a mean of the ranks'
    means: ``tests/test_torch_mesh.py`` holds that against JAX.  Then the
    fused dropout (kernels 6-7) on the data-parallel mesh: their launches
    a rank, and the first step's global gradients against one process's
    under the same rule, its noise the larger of two one-process runs'
    spread and the unfused data-parallel mesh's first-step gradients'
    distance from one process's (the split alone changes the shapes of
    the base's bf16 products, and so their rounding; the masks are held
    exactly by ``p17_dropout_rows``).  The rehearsal (``tiny``) runs
    P17_TINY_STEPS steps and one one-process run (the CPU repeats itself
    exactly)."""
    import torch
    import torch.distributed as dist
    from moka_tpu_torch.core.config import MeshConfig, TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.parallel import stream as tstream
    from moka_tpu_torch.parallel.mesh import data_parallel_index, make_mesh
    from moka_tpu_torch.parallel.sharding import shard_params
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import make_optimizer, tree_leaves
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    on_card = device == "cuda"
    cfg = dataclasses.replace(cfg, n_layers=2 if tiny else P17_FSDP_LAYERS)
    B, L = (4, 32) if tiny else (4, 1024)
    n_steps = sum(P17_TINY_STEPS if tiny else P17_STEPS)
    frozen, adapters = build_model(cfg, spec, seed=3, device=device)
    init = [p.clone() for p in tree_leaves(adapters)]
    batch = _mesh_batch(cfg, B, L, device)
    names = sorted((x, y) for x in PROJS for y in "ab")

    def by_proj(leaves):
        return {n: torch.cat([t.flatten().float() for (name, _), t in
                              zip(names, leaves) if name == n])
                for n in PROJS}

    def steps(base, local, mesh=None, sp=spec, count=n_steps):
        trainable = {"adapters": {"layers": {
            n: {k: v.clone() for k, v in p.items()}
            for n, p in adapters["layers"].items()}}}
        tx = make_optimizer(TrainConfig(), total_steps=1000)
        state = init_train_state(trainable, tx, DropoutKey(0))
        step = make_train_step(make_llama_moka_loss(
            cfg, sp, remat=True, use_flash=True, fused_loss=True,
            ce_chunk=128, mesh=mesh), tx, mesh=mesh,
            grad_taps=lambda g: [t.clone() for t in tree_leaves(g)])
        losses, times, moved, first = [], [], [], None
        _zero_counts()
        for _ in range(count):
            tstream.reset_counts()
            _sync(device)
            t0 = time.perf_counter()
            state, m = step(state, base, local)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            moved.append(tstream.COUNTS["gathered_bytes"])
            first = m["grad_taps"] if first is None else first
        delta = by_proj([p - p0 for p, p0 in
                         zip(tree_leaves(state.params), init)])
        return {"losses": losses, "ms": times, "gathered": moved,
                "delta": delta, "grads": by_proj(first),
                "launches": _counts()}

    def spread_of(a, b, key):
        out = {p: rel(b[key][p], a[key][p]) for p in PROJS}
        out["loss"] = max(abs(x - y) for x, y in zip(a["losses"],
                                                     b["losses"]))
        return out

    def within(got, ref, spread, key):
        dl = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
        du = {p: rel(got[key][p], ref[key][p]) for p in PROJS}
        ok = dl <= REMAT_NOISE[0] * spread["loss"] + \
            REMAT_NOISE[1] * abs(ref["losses"][0]) and all(
                du[p] <= REMAT_NOISE[0] * spread[p] + REMAT_NOISE[1]
                for p in PROJS)
        return dl, du, ok

    def local_rows(mesh):
        index, size = data_parallel_index(mesh)
        rows = B // size
        return {k: (v[:, index * rows:(index + 1) * rows]
                    if k == "modality_masks" else
                    v[index * rows:(index + 1) * rows])
                for k, v in batch.items()}

    ref = spread = None
    if rank == 0:
        ref = steps(frozen, batch)
        spread = spread_of(ref, ref if tiny else steps(frozen, batch),
                           "delta")
    whole = sum(nbytes(t) for t in _leaves(frozen))
    n = dist.get_world_size()
    out = {}
    for name, mc in ((f"1,{n},1", MeshConfig(1, n, 1)),
                     (f"{n},1,1", MeshConfig(n, 1, 1))):
        mesh = make_mesh(mc)
        local_base = shard_params(mesh, frozen)
        held = sum(nbytes(t) for t in _leaves(local_base))
        local = local_rows(mesh)
        got = steps(local_base, local, mesh)
        rec = {"losses": got["losses"], "step_ms": got["ms"],
               "gathered_bytes_per_step": got["gathered"][-1],
               "resident_base_bytes": held, "whole_base_bytes": whole,
               "supervised": int((local["labels"][:, 1:] != -100).sum())}
        if mc.fsdp > 1:
            # every leaf but the norms is split over the fsdp ranks
            norms = sum(nbytes(t) for k, t in frozen["layers"].items()
                        if k.endswith("norm")) + nbytes(frozen["final_norm"])
            if held != (whole - norms) // mc.fsdp + norms:
                raise AssertionError(f"rank {rank} holds {held} bytes of a "
                                     f"{whole}-byte base under fsdp "
                                     f"{mc.fsdp}")
        if rank == 0:
            dl, du, ok = within(got, ref, spread, "delta")
            rec.update(loss_abs=dl, update_rel_l2=du, spread=spread,
                       one_losses=ref["losses"], one_ms=ref["ms"],
                       grad_rel_l2=spread_of(ref, got, "grads"))
            log(f"  (c) mesh {name}, {cfg.n_layers} layers (a depth cut: a "
                f"gloo all-gather of the full depth takes too long a step), "
                f"b {B} x L {L}: losses {[round(x, 5) for x in got['losses']]}"
                f" vs one process {[round(x, 5) for x in ref['losses']]} "
                f"(max |diff| {dl:.2e}, two one-process runs "
                f"{spread['loss']:.2e}); adapter updates rel L2 "
                f"{ {p: f'{v:.2e}' for p, v in du.items()} }, two "
                f"one-process runs "
                f"{ {p: f'{spread[p]:.2e}' for p in PROJS} } (rule: <= "
                f"{REMAT_NOISE[0]} x that + {REMAT_NOISE[1]}); this rank's "
                f"supervised tokens "
                f"{rec['supervised']}; resident base "
                f"{held / 2**30:.3f} of {whole / 2**30:.3f} GiB; gathered "
                f"{got['gathered'][-1] / 1e9:.3f} GB a step; step ms "
                f"{[round(t, 1) for t in got['ms']]} (two ranks share the "
                f"card: no speed figure)")
            if not ok:
                raise AssertionError(f"mesh {name} is not one process")
        out[name] = rec
        del local_base, got
        gc.collect()
        dist.barrier()

    # kernels 6-7 on the data-parallel mesh: each rank's kernels draw its
    # rows of the global batch's masks (the key's row map)
    fspec = spec.with_fused_dropout()
    mesh = make_mesh(MeshConfig(n, 1, 1))
    got = steps(frozen, local_rows(mesh), mesh, fspec, 1)
    want = _launches(flash_fwd=2 * cfg.n_layers,
                     flash_bwd_fused=cfg.n_layers,
                     dropout_a_fwd=2 * 7 * cfg.n_layers,
                     dropout_a_bwd=7 * cfg.n_layers) if on_card \
        else _launches()
    if got["launches"] != want:
        raise AssertionError(f"rank {rank}: fused-dropout mesh step "
                             f"launches {got['launches']}, want {want}")
    rec = {"launches": got["launches"], "losses": got["losses"]}
    if rank == 0:
        fref = steps(frozen, batch, None, fspec, 1)
        fspread = spread_of(fref, fref if tiny else
                            steps(frozen, batch, None, fspec, 1), "grads")
        split = out[f"{n},1,1"]["grad_rel_l2"]
        noise = {k: max(fspread[k], split[k]) for k in fspread}
        dl, dg, ok = within(got, fref, noise, "grads")
        rec.update(loss_abs=dl, grad_rel_l2=dg, spread=fspread,
                   split_rel_l2=split, one_losses=fref["losses"])
        log(f"  (c) fused dropout (kernels 6-7) on mesh {n},1,1: loss "
            f"{got['losses'][0]:.6f} vs one process {fref['losses'][0]:.6f}"
            f"; global gradients rel L2 "
            f"{ {p: f'{v:.2e}' for p, v in dg.items()} }, two one-process "
            f"runs {  {p: f'{fspread[p]:.2e}' for p in PROJS} }, the "
            f"unfused mesh's first step from one process "
            f"{ {p: f'{split[p]:.2e}' for p in PROJS} } (rule: <= "
            f"{REMAT_NOISE[0]} x the larger + {REMAT_NOISE[1]}); launches "
            f"a rank { {k: v for k, v in got['launches'].items() if v} }")
        if not ok:
            raise AssertionError("the fused-dropout mesh step is not one "
                                 "process")
    out[f"{n},1,1+fused_dropout"] = rec
    del frozen, adapters, got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def p17_cli(rank: int, work: Path, device: str) -> dict:
    """(d) The finetune CLI at its tiny preset on every rank: ``--mesh
    fsdp --host-offload`` (1, ranks, 1), 3 steps on phase 15's data files
    (a CLI wiring check: the numbers are (c)'s)."""
    import torch.distributed as dist
    from moka_tpu_torch.cli import finetune
    out = work / "finetune"
    argv = ["--tokenizer-json", str(work / "data" / "tokenizer.model"),
            "--avqa-annotation", str(work / "data" / "avqa.json"),
            "--model-preset", "tiny", "--global-batch", "4",
            "--pad-to", "256", "--epochs", "1", "--mesh", "fsdp",
            "--host-offload", "--output-dir", str(out), "--device", device]
    trainer, _ = finetune.main(argv)
    q = trainer.frozen["llama"]["layers"]["q"]
    rows = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()] \
        if rank == 0 else []
    rec = {"steps": int(trainer.state.step), "q_shape": list(q.shape),
           "q_device": str(q.device),
           "losses": [r["loss"] for r in rows if "loss" in r]}
    _rank_log(rank, f"  (d) finetune {' '.join(argv)} on "
              f"{dist.get_world_size()} ranks: {rec['steps']} steps, losses "
              f"{rec['losses']}; this rank's q {rec['q_shape']} on "
              f"{rec['q_device']}")
    if rec["steps"] < 2 or q.device.type != "cpu" or \
            not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"finetune --mesh fsdp --host-offload: {rec}")
    return rec


def p17_rank(rank: int, work: Path, device: str, tiny: bool) -> None:
    """One rank of phase 17's world: (b), (c) and (d), then phase 20's (d)
    (kernel 5 under the ring, ``p20_ring``); its results in
    ``p17_r<rank>.json``."""
    import torch
    import torch.distributed as dist
    from moka_tpu_torch.parallel import comm
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":  # ranks beyond the cards share them
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # the rehearsal: each rank a core's worth of threads
        torch.set_num_threads(1)
    long_cfg, cfg, spec = p17_configs(tiny)
    out = {"transport": {op: comm.transport(dist.group.WORLD, op) for op in
                         ("all_reduce", "all_gather", "send")},
           "backend": dist.get_backend()}
    out["seconds"] = {}
    for part, fn in (("ring", lambda: p17_ring(rank, long_cfg, spec, device,
                                               tiny)),
                     ("mesh", lambda: p17_mesh(rank, cfg, spec, device,
                                               tiny)),
                     ("cli", lambda: p17_cli(rank, work, device)),
                     ("ring_fused", lambda: p20_ring(rank, device, tiny))):
        t0 = time.perf_counter()
        out[part] = fn()
        out["seconds"][part] = time.perf_counter() - t0
    (work / f"p17_r{rank}.json").write_text(json.dumps(out, default=float))


def phase17(work: Path, device: str = "cuda", tiny: bool = False,
            smi: str = "") -> dict:
    """Phase 17: parallelism at LLaMA-2-7B's width (``tiny``: the
    rehearsal on the CPU).  (a) the host-streamed base in this process;
    then a world of P17_RANKS ranks on the one card (gloo:
    ``parallel.mesh.run_world``) for (b) the flash ring, (c) the FSDP and
    data-parallel steps and (d) the finetune CLI over a mesh with
    ``--host-offload``."""
    import torch
    long_cfg, cfg, spec = p17_configs(tiny)
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)

    def here() -> dict:
        out = {"stream": p17_stream(cfg, spec, device, tiny, smi),
               "dropout_rows": p17_dropout_rows(device, tiny)}
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        return out

    # the card runs (a) alone (its peaks and times), the rehearsal beside
    # the world (the ranks' start-up takes most of its time)
    res = {} if tiny else here()
    log(f"  a world of {P17_RANKS} ranks on the {device} (gloo groups: "
        f"CUDA tensors in its all-reduce and all-gather as they are, in its "
        f"sends as host copies)")
    res.update(p17_world(work, device, tiny, P17_RANKS, "gloo",
                         beside=here if tiny else None))
    return res


def p17_world(work: Path, device: str, tiny: bool, ranks: int,
              backend: str, beside=None) -> dict:
    """(b), (c) and (d) in a world of ``ranks`` ranks over ``backend``
    (gloo: the ranks share the card; NCCL: one card a rank); rank 0's
    results, with every rank's ring launches, and those of ``beside()``,
    run in this process while the world runs."""
    from moka_tpu_torch.parallel.mesh import start_world, wait_world
    # (d)'s files, at the tiny preset's image size
    p15_data(work / "data", p15_configs(True)[1].image_size, 2)
    t0 = time.perf_counter()
    ctx = start_world(p17_rank, ranks, (work, device, tiny), backend=backend)
    try:
        here = beside() if beside is not None else {}
    finally:
        wait_world(ctx, timeout=900)
    got = [json.loads((work / f"p17_r{r}.json").read_text())
           for r in range(ranks)]
    for r in got[1:]:
        for name, rec in got[0]["mesh"].items():
            if r["mesh"][name]["losses"] != rec["losses"]:
                raise AssertionError(f"the ranks' mesh {name} losses differ")
    res = dict(got[0], world_s=time.perf_counter() - t0, **here)
    res["ring"]["launches_by_rank"] = [r["ring"]["launches"] for r in got]
    for name in res["ring_fused"]:
        res["ring_fused"][name]["launches_by_rank"] = [
            r["ring_fused"][name]["launches"] for r in got]
    log(f"  the world ran in {res['world_s']:.1f} s (rank 0: "
        f"{ {k: round(v, 1) for k, v in res['seconds'].items()} } s); "
        f"transport "
        f"{res['transport']} ({res['backend']})")
    return res


# ------------------------------------------------------------------ phase 18

P18_WORLDS = (2, 4)  # ranks of its two worlds on the one card (gloo)
P18_LAYERS = 4  # (a) at 7B widths: a depth cut, as phase 17 (c)'s
P18_SHORT = 2   # (b)'s fused-dropout step, (c) 34B widths and (d) int4
P18_BATCH = (4, 512)  # global rows x positions of every step
P18_STEPS = 2
P18_COLS = (4096, 11008)  # (b): 7B's o and down inputs, split at c0
P18_MESHES = {2: (("a", (1, 1, 2)), ("b", (1, 1, 2)), ("d", (1, 1, 2))),
              4: (("a", (1, 2, 2)), ("c", (1, 1, 4)))}


def p18_cases(tiny: bool) -> dict:
    """(config, spec, loss options) of each case: (a) phase 6's LLaMA-2-7B
    and MokA AVT r4 at P18_LAYERS layers, flash, chunked CE, proj_lse;
    (b) the same at P18_SHORT layers with fused dropout (kernels 6-7) and
    bf16 dots, as phase 8; (c) CodeLlama-34B's widths (dim 8192, 64 heads,
    8 kv heads: GQA 8:1, intermediate 22016) at P18_SHORT layers; (d)
    phase 9's quantized recipe (int4 base, int8 head, a8 full, save_q8,
    bf16 dots, route B: kernels 8-9) at P18_SHORT layers.  ``tiny``: the
    CPU rehearsal's widths (8 heads, intermediate 176; 4 kv heads in
    (c))."""
    from moka_tpu_torch.core.config import LlamaConfig
    cfg, spec = train_config()
    big = LlamaConfig.llama_34b()
    if tiny:
        cfg = LlamaConfig(vocab_size=300, dim=64, n_layers=2, n_heads=8,
                          n_kv_heads=8, intermediate=176)
        big = dataclasses.replace(cfg, n_kv_heads=4)
        spec = dataclasses.replace(spec, max_question_tokens=8)
    short = 2 if tiny else P18_SHORT
    loss = dict(remat=True, use_flash=True, fused_loss=True,
                remat_policy="proj_lse")
    return {
        "a": (dataclasses.replace(cfg, n_layers=2 if tiny else P18_LAYERS),
              spec, loss),
        "b": (dataclasses.replace(cfg, n_layers=short),
              spec.with_bf16_dots().with_fused_dropout(), loss),
        "c": (dataclasses.replace(big, n_layers=short), spec, loss),
        "d": (dataclasses.replace(cfg, n_layers=short), spec.with_bf16_dots(),
              dict(loss, pallas_ce=True, **QUANT_RECIPE))}


def p18_model(case: str, tiny: bool, device: str):
    """The case's base (bf16, or (d)'s int4 base with an int8 head built
    on the device) and fp32 adapters, B seeded non-zero: the same on every
    rank."""
    import torch
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.quant import init_llama_params_quantized
    cfg, spec, _ = p18_cases(tiny)[case]
    if case != "d":
        return build_model(cfg, spec, seed=3, device=device)
    g = torch.Generator(device=device).manual_seed(3)
    base = init_llama_params_quantized(g, cfg, bits=4, head_bits=8,
                                       device=device)
    adapters = llama.init_moka_adapters(g, cfg, spec, device=device)
    for p in adapters["layers"].values():
        p["b"].normal_(0.0, 0.02, generator=g)
    return base, adapters


def _by_proj(leaves) -> dict:
    """Adapter leaves (``tree_leaves`` order: projections sorted, a then
    b) flattened and concatenated by projection."""
    import torch
    names = sorted((x, y) for x in PROJS for y in "ab")
    return {n: torch.cat([t.flatten().float() for (name, _), t in
                          zip(names, leaves) if name == n])
            for n in PROJS}


def p18_steps(case: str, tiny: bool, base, adapters, batch, mesh=None,
              count: int = P18_STEPS) -> dict:
    """``count`` steps of ``make_train_step`` on ``batch`` (this rank's
    rows under ``mesh``): losses, step ms, the adapters' gradients of each
    step and their updates by projection, the last step's launches, flash
    launches by query heads and offset dropout launches, and the bytes
    all-reduced over the model group a step."""
    import torch
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    from moka_tpu_torch.ops.flash_attention import flash_bwd_fused, flash_fwd
    from moka_tpu_torch.parallel import comm
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import make_optimizer, tree_leaves
    from moka_tpu_torch.train.step import init_train_state, make_train_step
    cfg, spec, loss = p18_cases(tiny)[case]
    init = [p.clone() for p in tree_leaves(adapters)]
    trainable = {"adapters": {"layers": {
        n: {k: v.clone() for k, v in p.items()}
        for n, p in adapters["layers"].items()}}}
    tx = make_optimizer(TrainConfig(), total_steps=1000)
    state = init_train_state(trainable, tx, DropoutKey(0))
    step = make_train_step(make_llama_moka_loss(cfg, spec, mesh=mesh,
                                                **loss), tx, mesh=mesh,
                           grad_taps=lambda g: [t.clone() for t in
                                                tree_leaves(g)])
    model = None if mesh is None or "model" not in mesh.mesh_dim_names \
        else mesh.get_group("model")
    out = {"losses": [], "ms": [], "reduced": [], "grads": []}
    dev = batch["tokens"].device
    for _ in range(count):
        _zero_counts()
        comm.REDUCED_BYTES.clear()
        _sync(str(dev.type))
        t0 = time.perf_counter()
        state, m = step(state, base, batch)
        out["losses"].append(float(m["loss"]))
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["reduced"].append(comm.REDUCED_BYTES.get(model, 0))
        out["grads"].append(_by_proj(m["grad_taps"]))
    out["launches"] = _counts()
    out["fwd_heads"] = dict(flash_fwd.launches_by_heads)
    out["bwd_heads"] = dict(flash_bwd_fused.launches_by_heads)
    out["offset"] = (fd.dropout_a_fwd.offset_launches,
                     fd.dropout_a_bwd.offset_launches)
    out["delta"] = _by_proj([p - p0 for p, p0 in
                             zip(tree_leaves(state.params), init)])
    return out


def _p18_noise(a: dict, b: dict) -> dict:
    """Two runs' distance: the largest loss difference and, by projection,
    the largest relative L2 of a step's gradients (the updates, Adam's
    per-entry normalisation of them, are reported: ``update_rel_l2``)."""
    out = {p: max(rel(gb[p], ga[p]) for ga, gb in
                  zip(a["grads"], b["grads"])) for p in PROJS}
    out["loss"] = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    return out


def p18_exact(case: str, tiny: bool, base, adapters, batch) -> dict:
    """The case's first step in fp32: the base's values in fp32 (a
    quantized base keeps its codes), eager attention and the plain
    versions of the other kernels, the first step's dropout key: its
    loss and gradients by projection."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    from moka_tpu_torch.train.optim import tree_leaves
    cfg, spec, loss = p18_cases(tiny)[case]
    trainable = {"adapters": adapters}
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with plain_versions():
            value, _ = make_llama_moka_loss(cfg, spec, **dict(
                loss, use_flash=False))(trainable, float32(base), batch,
                                        DropoutKey(0).split(2)[1])
            grads = torch.autograd.grad(value, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return {"loss": float(value.detach()), "grads": _cpu_tree(
        {"delta": {}, "grads": [_by_proj(grads)]})["grads"][0]}


def p18_within(got: dict, ref: dict) -> tuple:
    """(the distances, within the rule).  The rule, phase 6's: the first
    step's loss and each projection's gradients at most TRAIN_RATIO times
    (+ TRAIN_FLOOR) as far from the fp32 step (``p18_exact``) as one
    process's, and every step's loss within TRAIN_FLOOR of one process's
    (relative).  Reported beside it: the distance from one process
    against two one-process runs' spread (REMAT_NOISE's terms)."""
    d = _p18_noise(ref, got)
    exact = ref["exact"]
    d["fp32"] = {p: rel(got["grads"][0][p], exact["grads"][p])
                 for p in PROJS}
    d["one_fp32"] = {p: rel(ref["grads"][0][p], exact["grads"][p])
                     for p in PROJS}
    dl = abs(got["losses"][0] - exact["loss"])
    dl_one = abs(ref["losses"][0] - exact["loss"])
    ok = dl <= TRAIN_RATIO * dl_one + TRAIN_FLOOR * abs(exact["loss"]) and \
        d["loss"] <= TRAIN_FLOOR * abs(ref["losses"][0]) and all(
            d["fp32"][p] <= TRAIN_RATIO * d["one_fp32"][p] + TRAIN_FLOOR
            for p in PROJS)
    return d, ok


def _cpu_tree(rec: dict) -> dict:
    out = dict(rec, delta={p: t.cpu() for p, t in rec["delta"].items()})
    out["grads"] = [{p: t.cpu() for p, t in g.items()} for g in rec["grads"]]
    return out


def p18_references(work: Path, device: str, tiny: bool) -> dict:
    """Each case's one process on the global batch, twice on the card
    (the spread: kernel 2's dq reductions change order from run to run),
    and its first step in fp32 (``p18_exact``), saved as
    ``ref_<case>.pt`` for the ranks."""
    import torch
    out = {}
    for case, (cfg, _, _) in p18_cases(tiny).items():
        base, adapters = p18_model(case, tiny, device)
        batch = _mesh_batch(cfg, *(_p18_batch(tiny)), device)
        count = 1 if case == "b" else P18_STEPS
        runs = [p18_steps(case, tiny, base, adapters, batch, count=count)
                for _ in range(1 if tiny else 2)]
        spread = _p18_noise(runs[0], runs[-1])
        exact = p18_exact(case, tiny, base, adapters, batch)
        rec = dict(_cpu_tree(runs[0]), spread=spread, exact=exact)
        torch.save(rec, work / f"ref_{case}.pt")
        out[case] = {"losses": runs[0]["losses"], "ms": runs[0]["ms"],
                     "spread": spread, "fp32_loss": exact["loss"],
                     "launches": {
                         k: v for k, v in runs[0]["launches"].items() if v}}
        log(f"  one process, case ({case}): {cfg.n_layers} layers, dim "
            f"{cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads: losses "
            f"{[round(x, 5) for x in runs[0]['losses']]}, step ms "
            f"{[round(t, 1) for t in runs[0]['ms']]}, two runs' spread "
            f"{ {k: f'{v:.2e}' for k, v in spread.items()} }")
        del base, adapters, batch, runs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _p18_batch(tiny: bool) -> tuple:
    return (4, 32) if tiny else P18_BATCH


def p18_dropout_cols(device: str, tiny: bool) -> dict:
    """(b) Kernels 6-7 on column slices [c0, c0 + d/m) of a 7B-width x
    (P18_COLS: o's and down's inputs, m 2 and 4, bf16 x and A, M*r 12)
    at the key's column view, against the same columns of the whole
    array's launch: the keep masks and dx identical, out summed over the
    slices and dA's rows within DROP_TOL of the whole's, and the plain
    versions at the same offset dropping the same elements."""
    import torch
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops import fused_dropout as fd
    n = 64 if tiny else P18_BATCH[0] * P18_BATCH[1]
    g = torch.Generator(device=device).manual_seed(18)
    out = {}
    for d in ((176,) if tiny else P18_COLS):
        x = torch.randn((n, d), generator=g, device=device).to(torch.bfloat16)
        a = (torch.randn((d, 12), generator=g, device=device) * 0.02).to(
            torch.bfloat16)
        gout = torch.randn((n, 12), generator=g, device=device)
        key = DropoutKey(11).rows(0, 8, 4 * n)
        rows = key.row_map((1, n, d))
        whole = fd.dropout_a_fwd(x, a, key, DROP_RATE, rows=rows)
        wdx, wda = fd.dropout_a_bwd(x, a, gout, key, DROP_RATE, rows=rows)
        for m in (2, 4):
            w = d // m
            total = torch.zeros_like(whole)
            worst = {"dx_mismatch": 0.0, "da": 0.0}
            for i in range(m):
                c0 = i * w
                part = key.cols(c0, d)
                xs, as_ = x[:, c0:c0 + w].contiguous(), \
                    a[c0:c0 + w].contiguous()
                total += fd.dropout_a_fwd(xs, as_, part, DROP_RATE, rows=rows,
                                          col0=c0)
                dx, da = fd.dropout_a_bwd(xs, as_, gout, part, DROP_RATE,
                                          rows=rows, col0=c0)
                pdx, _ = fd.dropout_a_bwd_plain(xs, as_, gout, part,
                                                DROP_RATE, rows=rows, col0=c0)
                want_dx = wdx[:, c0:c0 + w]
                if not torch.equal(dx != 0, want_dx != 0) or \
                        not torch.equal(dx != 0, pdx != 0):
                    raise AssertionError(f"kernel 7 at column offset {c0} "
                                         f"of {d}: masks differ")
                worst["dx_mismatch"] = max(worst["dx_mismatch"], float(
                    (dx != want_dx).float().mean()))
                worst["da"] = max(worst["da"], float(
                    (da.float() - wda[c0:c0 + w].float()).abs().max() /
                    wda.float().abs().max()))
            e_out = float((total - whole).abs().max() / whole.abs().max())
            rec = dict(worst, out=e_out)
            out[f"{d}/{m}"] = rec
            log(f"  (b) kernels 6-7 on column slices of x ({n}, {d}) bf16 "
                f"over {m} ranks (c0 = i x {w}): masks = the whole launch's "
                f"and the plain versions'; dx elements not bit-identical "
                f"{worst['dx_mismatch']:.2e}; dA rows {worst['da']:.2e} and "
                f"the slices' summed out {e_out:.2e} of max (tol "
                f"{DROP_TOL})")
            if worst["dx_mismatch"] > 0 or worst["da"] > DROP_TOL or \
                    e_out > DROP_TOL:
                raise AssertionError(f"kernels 6-7 on column slices of {d} "
                                     f"over {m}: {rec}")
        del x, a, gout, whole, wdx, wda
    return out


def _expected_resident(mesh, whole: dict) -> int:
    """A rank's bytes of ``whole`` under the rule table on ``mesh``: each
    leaf over the product of its split axes."""
    from moka_tpu_torch.parallel.mesh import axis_size
    from moka_tpu_torch.parallel.sharding import _names, param_shardings
    shardings = param_shardings(mesh, whole)

    def walk(tree, sh):
        if isinstance(tree, dict):
            return sum(walk(tree[k], sh[k]) for k in tree)
        n = 1
        for part in sh.spec:
            for name in _names(part):
                n *= axis_size(mesh, name)
        return nbytes(tree) // n
    return walk(whole, shardings)


def p18_case(rank: int, case: str, sizes: tuple, work: Path, device: str,
             tiny: bool) -> dict:
    """One case on this rank's mesh: the base split by the rule table (the
    whole base freed), P18_STEPS steps on its rows against the one-process
    and fp32 references by ``p18_within``; each rank's flash launches at its
    H/m query heads, once a layer a step; (b) each rank's kernels 6-7, at
    a column offset on the ranks past the first."""
    import torch
    import torch.distributed as dist
    from moka_tpu_torch.core.config import MeshConfig
    from moka_tpu_torch.parallel.mesh import data_parallel_index, make_mesh
    from moka_tpu_torch.parallel.sharding import shard_params
    cfg, spec, _ = p18_cases(tiny)[case]
    mc = MeshConfig(*sizes)
    mesh = make_mesh(mc)
    base, adapters = p18_model(case, tiny, device)
    whole = sum(nbytes(t) for t in _leaves(base))
    want_held = _expected_resident(mesh, base)
    local_base = shard_params(mesh, base)
    del base
    gc.collect()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = sum(nbytes(t) for t in _leaves(local_base))
    if held != want_held:
        raise AssertionError(f"rank {rank} holds {held} bytes of the base, "
                             f"want {want_held}")
    batch = _mesh_batch(cfg, *(_p18_batch(tiny)), device)
    index, size = data_parallel_index(mesh)
    rows = batch["labels"].shape[0] // size
    local = {k: (v[:, index * rows:(index + 1) * rows]
                 if k == "modality_masks" else
                 v[index * rows:(index + 1) * rows])
             for k, v in batch.items()}
    ref = torch.load(work / f"ref_{case}.pt")
    count = len(ref["losses"])
    got = _cpu_tree(p18_steps(case, tiny, local_base, adapters, local, mesh,
                              count))
    d, ok = p18_within(got, ref)
    moved = {p: rel(got["delta"][p], ref["delta"][p]) for p in PROJS}
    m = mc.model
    n = cfg.n_layers
    want_heads = {cfg.n_heads // m: n} if on_card else {}
    if got["fwd_heads"] != want_heads or got["bwd_heads"] != want_heads:
        raise AssertionError(f"rank {rank} case ({case}): flash launches by "
                             f"query heads {got['fwd_heads']} / "
                             f"{got['bwd_heads']}, want {want_heads}")
    want = {"flash_fwd": n, "flash_bwd_fused": n}
    if case == "b":  # every projection's delta, forward and recompute
        want.update(dropout_a_fwd=2 * 7 * n, dropout_a_bwd=7 * n)
    if case == "d":
        want.update(fused_ce_fwd=1, fused_ce_bwd=1)
    want = _launches(**want) if on_card else _launches()
    if got["launches"] != want:
        raise AssertionError(f"rank {rank} case ({case}): launches "
                             f"{got['launches']}, want {want}")
    c_rank = mesh.get_local_rank("model")
    if case == "b" and on_card and got["offset"] != \
            ((2 * 2 * n, 2 * n) if c_rank else (0, 0)):
        raise AssertionError(f"rank {rank}: kernels 6-7 at a column offset "
                             f"{got['offset']} times")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rec = {"losses": got["losses"], "step_ms": got["ms"],
           "model_reduced_bytes": got["reduced"][-1],
           "resident_base_bytes": held, "whole_base_bytes": whole,
           "peak_bytes": peak, "loss_abs": d["loss"],
           "grad_rel_l2": {p: d[p] for p in PROJS},
           "grad_rel_l2_fp32": d["fp32"], "one_rel_l2_fp32": d["one_fp32"],
           "update_rel_l2": moved,
           "spread": ref["spread"], "one_losses": ref["losses"],
           "launches": {k: v for k, v in got["launches"].items() if v},
           "offset_launches": got["offset"], "ok": ok}
    name = ",".join(map(str, sizes))
    spread = ref["spread"]
    _rank_log(rank, f"  ({case}) mesh {name}, {n} layers, dim {cfg.dim}, "
              f"{cfg.n_heads // m} query / "
              f"{max(cfg.n_kv_heads // m, 1)} kv heads a rank: losses "
              f"{[round(x, 5) for x in got['losses']]} vs one process "
              f"{[round(x, 5) for x in ref['losses']]} (|diff| "
              f"{d['loss']:.2e}, spread {ref['spread']['loss']:.2e}); "
              f"first step's gradients rel L2 from fp32 "
              f"{ {p: f'{v:.2e}' for p, v in d['fp32'].items()} }, one "
              f"process's { {p: f'{v:.2e}' for p, v in d['one_fp32'].items()} }"
              f" (rule: <= {TRAIN_RATIO} x one process's + {TRAIN_FLOOR}; "
              f"losses within {TRAIN_FLOOR} of one process's, relative); "
              f"gradients rel L2 from one process "
              f"{ {p: f'{d[p]:.2e}' for p in PROJS} }, two one-process runs' "
              f"spread { {p: f'{spread[p]:.2e}' for p in PROJS} }; "
              f"updates rel L2 { {p: f'{v:.2e}' for p, v in moved.items()} };"
              f" "
              f"step ms {[round(t, 1) for t in got['ms']]} (ranks share "
              f"the card through gloo); all-reduced over the model group "
              f"{got['reduced'][-1] / 1e6:.1f} MB a step; resident base "
              f"{held / 2**30:.3f} of {whole / 2**30:.3f} GiB; peak "
              f"{peak / 2**30:.2f} GiB; launches {rec['launches']}")
    if not ok:
        raise AssertionError(f"rank {rank} case ({case}) on {name} is not "
                             f"one process: {d}")
    del local_base, adapters, got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    return rec


def p18_cli(rank: int, work: Path, device: str) -> dict:
    """(e) The finetune CLI at its tiny preset on two ranks, ``--mesh
    1,1,2 --host-offload``: each rank holds half of q's columns in host
    memory (a wiring check: the numbers are (a)-(d)'s)."""
    import torch.distributed as dist
    from moka_tpu_torch.cli import finetune
    from moka_tpu_torch.parallel.sharding import shard_info
    out = work / "finetune"
    argv = ["--tokenizer-json", str(work / "data" / "tokenizer.model"),
            "--avqa-annotation", str(work / "data" / "avqa.json"),
            "--model-preset", "tiny", "--global-batch", "4",
            "--pad-to", "256", "--epochs", "1", "--mesh", "1,1,2",
            "--host-offload", "--output-dir", str(out), "--device", device]
    trainer, _ = finetune.main(argv)
    q = trainer.frozen["llama"]["layers"]["q"]
    rows = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()] \
        if rank == 0 else []
    rec = {"steps": int(trainer.state.step), "q_shape": list(q.shape),
           "q_device": str(q.device),
           "losses": [r["loss"] for r in rows if "loss" in r]}
    _rank_log(rank, f"  (e) finetune {' '.join(argv)} on "
              f"{dist.get_world_size()} ranks: {rec['steps']} steps, losses "
              f"{rec['losses']}; this rank's q {rec['q_shape']} on "
              f"{rec['q_device']}")
    info = shard_info(q)
    if rec["steps"] < 2 or q.device.type != "cpu" or info is None or \
            info.placement.spec != (None, "fsdp", "model") or \
            not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"finetune --mesh 1,1,2 --host-offload: {rec}")
    return rec


def p18_rank(rank: int, work: Path, device: str, tiny: bool,
             world: int) -> None:
    """One rank of a phase 18 world: its cases (P18_MESHES) and, in the
    two-rank world, (e); its results in ``p18_<world>_r<rank>.json``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":  # ranks beyond the cards share them
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    out, seconds = {}, {}
    for case, sizes in P18_MESHES[world]:
        t0 = time.perf_counter()
        out[f"{case}/{','.join(map(str, sizes))}"] = p18_case(
            rank, case, sizes, work, device, tiny)
        seconds[case] = time.perf_counter() - t0
    if world == 2:
        t0 = time.perf_counter()
        out["cli"] = p18_cli(rank, work, device)
        seconds["cli"] = time.perf_counter() - t0
    out["seconds"] = seconds
    (work / f"p18_{world}_r{rank}.json").write_text(
        json.dumps(out, default=float))


def phase18(work: Path, device: str = "cuda", tiny: bool = False,
            smi: str = "") -> dict:
    """Phase 18: tensor parallelism on the model axis at 7B and 34B widths
    (``tiny``: the CPU rehearsal).  (b)'s kernel checks and every case's
    one-process reference in this process, then two worlds on the one card
    (gloo groups, as phase 17): two ranks for (a) 1,1,2, (b) the
    fused-dropout step, (d) the int4 base and (e) the finetune CLI; four
    for (a) 1,2,2 and (c) 34B widths on 1,1,4, side by side (their
    start-ups overlap)."""
    import torch
    from moka_tpu_torch.parallel.mesh import start_world, wait_world
    t_phase = time.perf_counter()
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    res = {"dropout_cols": p18_dropout_cols(device, tiny)}
    res["one_process"] = p18_references(work, device, tiny)
    p15_data(work / "data", p15_configs(True)[1].image_size, 2)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctxs = [start_world(p18_rank, world, (work, device, tiny, world))
            for world in P18_WORLDS]
    try:
        for ctx in ctxs:
            wait_world(ctx, timeout=600)
    finally:  # a failed world leaves the other's ranks to be ended
        for ctx in ctxs:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    for world in P18_WORLDS:
        got = [json.loads((work / f"p18_{world}_r{r}.json").read_text())
               for r in range(world)]
        for r in got[1:]:
            for name, rec in got[0].items():
                if name not in ("seconds", "cli") and \
                        r[name]["losses"] != rec["losses"]:
                    raise AssertionError(f"the ranks' {name} losses differ")
        res[f"world{world}"] = dict(got[0], world_s=time.perf_counter() - t0,
                                    launches_by_rank=[
                                        {k: v["launches"] for k, v in r.items()
                                         if k not in ("seconds", "cli")}
                                        for r in got])
        log(f"  the {world}-rank world (side by side with the other) ran in "
            f"{res[f'world{world}']['world_s']:.1f} s to its end (rank 0: "
            f"{ {k: round(v, 1) for k, v in got[0]['seconds'].items()} } s)")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 18 wall {res['phase_s']:.1f} s ({smi})")
    return res


# ------------------------------------------------------------------ phase 19

P19_RANKS = (1, 2, 6, 12, 32, 64)  # kernel 5's ranks, AVT (M 3)
P19_VT_RANK = 32                    # and VT (M 2)
P19_DROP_MRS = (6, 18, 96, 192, 256)  # kernels 6-7: ranks 2, 6, 32, 64 x 3
                                      # modalities and 64 x 4
P19_RANK_DIMS = (2, 6, 32, 64)      # R1-R3: rank attention head dims
P19_MOKA_M4 = (12, 64)  # kernel 5 with four modalities (64: its four passes)
P19_MOKA_F32 = (6, 32, 64)  # kernel 5 on fp32 x (its rank slices of 16)
P19_SERVED = (32, 6)  # ranks phase 4's base serves in full (logits rule)
P19_STEP = (32, 8)    # the fused training step: rank, layers (a depth cut)
P19_STEP_RANKS = (2, 6, 64)  # one more step each, for their instances'
                             # launches on a main path
P19_CLI_RANK = 32     # infer --lora-r
P19_CLI_SAMPLES = 4
P19_LIMIT_S = 120     # the phase's wall, (a)-(d), at most


def p19_layer_shapes(cfg) -> dict:
    return {"q": (cfg.dim, cfg.dim), "k": (cfg.dim, cfg.dim),
            "v": (cfg.dim, cfg.dim), "o": (cfg.dim, cfg.dim),
            "gate": (cfg.dim, cfg.intermediate),
            "up": (cfg.dim, cfg.intermediate),
            "down": (cfg.intermediate, cfg.dim)}


def p19_moka_shapes() -> dict:
    """Kernel 5's other instances past rank 16 against the plain version
    (``check_moka``): four modalities (three attending) at each rank of
    P19_MOKA_M4, fp32 x with a question mask with gaps at each of
    P19_MOKA_F32, and rank 64 with a question span past the main kernel's
    key chunk (KCAP 64 keys, 109 here); max|err| by the rank's record."""
    import torch
    errs = {}
    for rank in P19_MOKA_M4:
        x, a, bm, mod, qm, spec = moka_inputs(4, 500, 1024, 2048, "avt",
                                              torch.bfloat16, 11, rank)
        spec = dataclasses.replace(spec, num_modalities=4,
                                   attn_modalities=(1, 2, 3))
        a = torch.cat([a, a[2:]]).contiguous()
        mod = torch.cat([mod, mod[2:]]).contiguous()
        d = check_moka(f"M 4 r{rank} bf16 1024->2048", x, a, bm, mod, qm,
                       spec)
        errs[f"avt_r{rank}"] = max(errs.get(f"avt_r{rank}", 0.0), d)
    for rank in P19_MOKA_F32:
        d = check_moka(f"fp32 x r{rank} 512->1024, question gaps",
                       *moka_inputs(2, 200, 512, 1024, "avt", torch.float32,
                                    3, rank, qspans=MOKA_SPLIT_Q))
        errs[f"avt_r{rank}_fp32"] = d
    d = check_moka("r64 bf16 1024->1024, 109 question keys",
                   *moka_inputs(2, 2 * 64 + 152, 1024, 1024, "avt",
                                torch.bfloat16, 5, 64,
                                qspans=((1, 64 + 45),)))
    errs["avt_r64"] = max(errs.get("avt_r64", 0.0), d)
    return errs


def p19_moka_records(cfg, b=8, L=896, ranks=P19_RANKS, vt_rank=P19_VT_RANK,
                     more=None) -> list[dict]:
    """Kernel 5 at each of ``ranks`` (AVT) and at ``vt_rank`` (VT), bf16,
    at the serving prefill (b, L): every distinct projection shape of a
    LLaMA-2-7B layer against the plain version (``check_moka``), then the
    layer's seven projections timed (the kernel alone in a CUDA graph),
    beside the plain version and the bound (the bytes of x, A, B, the
    masks and the delta; the products at the true rank at the tensor
    cores' bf16 rate at every rank, the attention at the fp32 rate).  ``more``'s checks
    (``p19_moka_shapes``'s by default) go into the rank's record (bf16),
    and its fp32 ones into ``fp32_x_max_abs_err``."""
    import torch
    from moka_tpu_torch.ops.moka_pallas import (KERNEL_RANKS, kernel_rank,
                                                moka_delta_fused,
                                                moka_delta_fused_plain)
    from profile_port import graph_ms
    shapes = p19_layer_shapes(cfg)
    more = p19_moka_shapes() if more is None else more
    records = []
    for flavour, rank in [("avt", r) for r in ranks] + [("vt", vt_rank)]:
        err = more.get(f"{flavour}_r{rank}", 0.0)
        for i, (d_in, d_out) in enumerate(sorted(set(shapes.values()))):
            err = max(err, check_moka(
                f"{flavour} r{rank} (instance r{kernel_rank(rank)}) bf16 "
                f"{d_in}->{d_out}",
                *moka_inputs(b, L, d_in, d_out, flavour, torch.bfloat16,
                             60 + i, rank)))
        t = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)
        for name, (d_in, d_out) in shapes.items():
            x, a, bm, mod, qm, spec = moka_inputs(
                b, L, d_in, d_out, flavour, torch.bfloat16, 70, rank)

            def call():
                moka_delta_fused(x, a, bm, mod, qm, spec)

            t["ms"] += graph_ms(call, n=10)
            t["plain_ms"] += time_ms(lambda: moka_delta_fused_plain(
                x, a, bm, mod, qm, spec), iters=2, warmup=1)
            t["bytes"] += nbytes(x, a, bm, mod, qm) + \
                b * L * d_out * x.element_size()
            M, nq = spec.num_modalities, float(qm.sum(dim=-1).max())
            n_att = len(spec.attn_modalities)
            # the function's work at the true rank, whatever the design:
            # the down and up products at the tensor cores' bf16 rate (the
            # wide path's fp32 FMAs are its choice, not the function's),
            # the attention in fp32
            t["ops"] += 2.0 * b * L * (d_in * M * rank + d_out * rank) / \
                BF16_FLOPS + 2.0 * b * L * nq * 2 * n_att * rank / FP32_FLOPS
            del x
        bms, by = bound_ms(t["bytes"], t["ops"], 1.0)
        log(f"  moka {flavour} r{rank} (instance r{kernel_rank(rank)}), a "
            f"layer's seven projections (b {b}, L {L}, bf16): kernel alone "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; the kernel {t['ms'] / bms:.2f}x it)")
        records.append({
            "name": f"moka_delta_fwd_{flavour}_r{rank}", "route": "cuda",
            "source": "moka_tpu_torch/kernels/csrc/moka_delta_fwd.cu",
            "replaces": "moka_tpu/ops/moka_pallas.py:112",
            "launches": None, "max_abs_err": err,
            "tolerance": MOKA_TOL["bfloat16"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "instance_rank": kernel_rank(rank),
            "design": "persistent TMA/wgmma kernel" if rank <=
            KERNEL_RANKS[-1] else "wide path: down product, R1, up product",
            "shape": f"b {b} L {L} bf16 {flavour.upper()} r{rank}, one "
                     f"layer: the seven projections summed, the kernel "
                     f"alone in a CUDA graph"})
        if f"{flavour}_r{rank}_fp32" in more:
            records[-1]["fp32_x_max_abs_err"] = \
                more[f"{flavour}_r{rank}_fp32"]
    return records


def p19_dropout_records(cfg, n=4096, mrs=P19_DROP_MRS) -> list[dict]:
    """Kernels 6-7 at each M*r of ``mrs``, N ``n``, d the model's
    width and intermediate, bf16 x, fp32 A, Philox and forced words, and
    phase 3's ragged (333, 200) cases (fp32 x and A, Philox; bf16 x and
    A, forced words): ``check_dropout``'s rules and, beyond them, kernel
    7's dx equal to the plain version's bit for bit (the FMA chain in the
    plain version's order); then one layer's seven projections timed (bf16 x and A,
    Philox) beside the plain versions, ``F.dropout(x) @ A`` (phase 3's
    library yardstick; backward: its autograd backward alone) and the
    bound."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import fused_dropout as fd
    bf, f32 = torch.bfloat16, torch.float32
    dims = [cfg.dim] * 6 + [cfg.intermediate]
    records = []
    for mr in mrs:
        # the plain backward is M*r launches of an (N, d) addcmul_
        plain_iters = dict(iters=2, warmup=1) if mr <= 256 else \
            dict(iters=1, warmup=0)
        err = 0.0
        for j, (rows, d, xdt, adt, forced) in enumerate((
                (n, cfg.dim, bf, f32, False),
                (n, cfg.intermediate, bf, f32, True),
                (333, 200, f32, f32, False), (333, 200, bf, bf, True))):
            x, a, gout, key, bits = dropout_case(rows, d, xdt, adt, forced,
                                                 seed=80 + j, mr=mr)
            # dx bit for bit ("not bit-identical" 0)
            err = max(err, check_dropout(
                f"M*r {mr} ({rows}, {d}) x {str(xdt)[6:]} A {str(adt)[6:]}",
                x, a, gout, key, bits, exact_dx=True))
            del x, a, gout, bits
        tot = {k: 0.0 for k in ("fwd", "bwd", "fwd_plain", "bwd_plain",
                                "fwd_lib", "bwd_lib", "fwd_bytes",
                                "bwd_bytes", "fwd_flops", "bwd_flops",
                                "bwd_fma", "philox", "philox_mul")}
        for d in dims:
            x, a, gout, key, _ = dropout_case(n, d, bf, bf, False, seed=85,
                                              mr=mr)
            tot["fwd"] += time_ms(lambda: fd.dropout_a_fwd(x, a, key,
                                                           DROP_RATE))
            tot["bwd"] += time_ms(lambda: fd.dropout_a_bwd(x, a, gout, key,
                                                           DROP_RATE))
            tot["fwd_plain"] += time_ms(lambda: fd.dropout_a_fwd_plain(
                x, a, key, DROP_RATE), iters=2, warmup=1)
            tot["bwd_plain"] += time_ms(lambda: fd.dropout_a_bwd_plain(
                x, a, gout, key, DROP_RATE), **plain_iters)
            xg = x.clone().requires_grad_(True)
            ag = a.clone().requires_grad_(True)
            gb = gout.to(torch.bfloat16)
            lib_out = F.dropout(xg, DROP_RATE) @ ag
            tot["fwd_lib"] += time_ms(lambda: F.dropout(xg, DROP_RATE) @ ag)
            tot["bwd_lib"] += time_ms(lambda: torch.autograd.grad(
                lib_out, (xg, ag), gb, retain_graph=True))
            del xg, ag, gb, lib_out
            elems = n * d
            tot["fwd_bytes"] += nbytes(x, a) + n * mr * 4
            tot["bwd_bytes"] += 2 * nbytes(x) + nbytes(a, gout) + nbytes(a)
            tot["fwd_flops"] += 2 * elems * mr
            tot["bwd_flops"] += 2 * elems * mr
            tot["bwd_fma"] += 2 * elems * mr  # dx's fp32 chain
            tot["philox"] += elems / 4 * PHILOX["instructions"]
            tot["philox_mul"] += elems / 4 * PHILOX["multiplies"]
            del x, a, gout
        for which, line, kernel in (("fwd", 127, 6), ("bwd", 157, 7)):
            more = [(tot["philox"], LANE_INSTR),
                    (tot["philox_mul"], IMUL_RATE)]
            if which == "bwd":
                more.append((tot["bwd_fma"], FP32_FLOPS))
            bms, by = bound_ms(tot[f"{which}_bytes"], tot[f"{which}_flops"],
                               BF16_FLOPS, *more)
            log(f"  dropout {which} M*r {mr}, one layer's seven projections "
                f"(N {n}, d {cfg.dim} x6 + {cfg.intermediate}, bf16 x and A, "
                f"Philox): kernel {tot[which]:.4f} ms, plain "
                f"{tot[which + '_plain']:.4f} ms, F.dropout + matmul "
                f"{tot[which + '_lib']:.4f} ms, bound {bms:.4f} ms ({by})")
            records.append({
                "name": f"dropout_a_{which}_mr{mr}", "route": "cuda",
                "source": "moka_tpu_torch/kernels/csrc/fused_dropout.cu",
                "replaces": f"moka_tpu/ops/fused_dropout.py:{line}",
                "launches": None, "max_abs_err": err,
                "tolerance": f"out, dA {DROP_TOL} of max|plain|; dx bit for "
                             f"bit; masks exact",
                "ms": tot[which], "plain_ms": tot[which + "_plain"],
                "bound_ms": bms, "bound_by": by,
                "library_ms": tot[which + "_lib"],
                "library": "F.dropout(x) @ A_flat in bf16" + (
                    "" if which == "fwd" else
                    ", its autograd backward alone"),
                "shape": f"N {n}, d {cfg.dim} (6 projections) and "
                         f"{cfg.intermediate} (down), x and A bf16, Philox, "
                         f"M*r {mr}: one layer, seven launches of kernel "
                         f"{kernel}"})
    return records


def p19_rank_records(b=4, L=1024, dims=P19_RANK_DIMS,
                     layouts=False) -> list[dict]:
    """R1-R3 at each head dim of ``dims``: ``check_rank`` at (b, L)
    with 126 question keys a sample and a sample with none, and causal
    with rows before the first visible key (``layouts``: also phase 3's
    key layouts, RANK_LAYOUTS, and its ragged L); each kernel then timed
    beside
    its plain version, ``scaled_dot_product_attention`` (fp32, boolean key
    mask; the backward rows forward + backward less forward, as phase 3)
    and the bound."""
    import torch
    import torch.nn.functional as F
    from moka_tpu_torch.ops import flash_attention as fa
    records = []
    for hd in dims:
        errs = [check_rank(f"hd {hd}", *rank_case(b, L, hd=hd, dead=True,
                                                  seed=90 + hd)),
                check_rank(f"hd {hd} causal",
                           *rank_case(2, L, hd=hd, seed=95 + hd,
                                      spans=RANK_CAUSAL),
                           RANK_CAUSAL_OFFSET, True)]
        if layouts:
            errs += [check_rank(f"hd {hd} key layouts",
                                *rank_case(4, L, hd=hd, seed=3 + hd,
                                           spans=RANK_LAYOUTS)),
                     check_rank(f"hd {hd} ragged L",
                                *rank_case(3, 333, hd=hd, dead=True,
                                           seed=1 + hd))]
        q, k, v, mask, dout = rank_case(b, L, hd=hd, seed=99)
        out, lse = fa.flash_rank_fwd(q, k, v, mask, 0, False)
        delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
        args = (q, k, v, mask, dout, lse, delta, 0, False)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        bool_mask = (mask > 0)[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=bool_mask)

        lib_fwd = time_ms(sdpa, iters=20)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dout.transpose(1, 2)), iters=20) - lib_fwd
        seen = int(mask.sum())
        pairs = float(L * seen)
        row, rows = 4 * hd, b * L * 4
        kv_in = seen * 2 * row + nbytes(mask)
        for which, fn, plain, flops, n_bytes, line, names, lib in (
                ("fwd", lambda: fa.flash_rank_fwd(q, k, v, mask, 0, False),
                 lambda: fa.flash_fwd_plain(q, k, v, mask, 0, False),
                 4 * hd, 2 * nbytes(q) + kv_in + rows, 360, ("out", "lse"),
                 lib_fwd),
                ("bwd_dq", lambda: fa.flash_rank_bwd_dq(*args),
                 lambda: fa.flash_bwd_dq_plain(*args), 6 * hd,
                 3 * nbytes(q) + kv_in + 2 * rows, 428, ("dq",), lib_bwd),
                ("bwd_dkv", lambda: fa.flash_rank_bwd_dkv(*args),
                 lambda: fa.flash_bwd_dkv_plain(*args), 8 * hd,
                 2 * nbytes(q) + kv_in + 2 * rows + 2 * nbytes(k), 473,
                 ("dk", "dv"), lib_bwd)):
            ms = time_ms(fn, iters=20)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            bms, by = bound_ms(n_bytes, flops * pairs, FP32_FLOPS,
                               (pairs, SFU_OPS))
            log(f"  rank flash {which} hd {hd} (b {b}, L {L}, {seen // b} "
                f"question keys a sample): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib:.4f} ms (the kernel "
                f"{ms / lib:.2f}x it), bound {bms:.5f} ms ({by})")
            records.append({
                "name": f"flash_rank_{which}_hd{hd}", "route": "cuda",
                "source": "moka_tpu_torch/kernels/csrc/flash_rank.cu",
                "replaces": f"moka_tpu/ops/flash_attention.py:{line} (at "
                            f"head_dim r, moka_tpu/ops/moka.py:210)",
                "launches": None,
                "max_abs_err": max(e[n] for e in errs for n in names),
                "tolerance": f"{RANK_TOL if which == 'fwd' else RANK_BWD_TOL}"
                             f" of max|plain|",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": by, "library_ms": lib,
                "library": "scaled_dot_product_attention fp32, boolean key "
                           "mask" + ("" if which == "fwd" else
                                     ": forward + backward less forward"),
                "instance_head_dim": fa.rank_built_dim(hd),
                "shape": f"b {b} L {L} S {L} H 1 hd {hd} fp32, question keys "
                         f"2:{L // 8}, one call, the wrapper back to back"})
    return records


def p19_serving(cfg, base, inputs, new_tokens, served=P19_SERVED,
                ranks=P19_RANKS, vt_rank=P19_VT_RANK, engine=True) -> dict:
    """Phase 4's base (full depth) serving MokA AVT trees on the decode
    paths' default route: at each of ``served`` in full
    (``serve_other_rank``: the prefill logits under phase 4's rule, then
    ``greedy_generate`` and (``engine``) a ``DecodeEngine`` request, each
    with kernel 5 launched 7 x n_layers times a prefill); then one new
    token at each
    other rank of ``ranks`` and, on VT masks, at ``vt_rank``, whose launch
    counts are their instances' on the main path."""
    import torch
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.moka import MokaSpec
    out = {}
    for rank in served:
        log(f"  (b) a rank-{rank} AVT tree on phase 4's base")
        out[f"avt_r{rank}"] = serve_other_rank(cfg, base, inputs, new_tokens,
                                               rank, engine)
    n = cfg.n_layers
    for flavour, rank in [("avt", r) for r in ranks if r not in served] + \
            [("vt", vt_rank)]:
        spec = (MokaSpec.avt if flavour == "avt" else MokaSpec.vt)(
            rank=rank, dropout_rate=0.0)
        g = torch.Generator(device="cuda").manual_seed(100 + rank)
        adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
        for p in adapters["layers"].values():
            p["b"].normal_(0.0, 0.02, generator=g)
        ins = inputs
        if flavour == "vt":
            mod = inputs["masks"].modality
            ins = dict(inputs, masks=llama.MaskBundle(
                torch.stack([mod[0], mod[1] + mod[2]]),
                inputs["masks"].question))
        with torch.inference_mode():
            _zero_counts()
            toks = generate(cfg, spec, base, adapters, ins, 1)
            torch.cuda.synchronize()
            launches = _counts()
        want = _launches(flash_fwd=n, **moka_launches(spec, 7 * n))
        log(f"  (b) {flavour.upper()} r{rank}: one new token, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if launches != want or tuple(toks.shape) != (ins["inputs_embeds"]
                                                     .shape[0], 1):
            raise AssertionError(f"{flavour} r{rank} generate: launches "
                                 f"{launches}, want {want}")
        out[f"{flavour}_r{rank}"] = {"rank": rank,
                                     "generate_launches": launches}
        del adapters
    return out


def p19_training(cfg, base, step=P19_STEP,
                 step_ranks=P19_STEP_RANKS) -> dict:
    """The fused step at ``step``'s rank and depth (AVT, dropout 0.05,
    bf16 dots, kernels 6-7, the rank kernels, ``proj_lse``, b 4 L 1024) on
    phase 4's base cut to that depth: phase 8's gradient rules
    (``check_fused_train_grads``: kernels vs plain and fp32, proj_lse vs
    full remat) and phase 11's (``check_rank_train_grads``, without bf16
    dots: kernels vs plain and fp32, then in fp32 the rank kernels against
    the plain rank attention), then 2 + 1 steps with the launch counts
    asserted; then one step at each rank of ``step_ranks`` for their
    instances' launches."""
    import dataclasses
    import torch
    from moka_tpu_torch.models import llama
    from moka_tpu_torch.ops.moka import MokaSpec
    rank, depth = step
    cfg = dataclasses.replace(cfg, n_layers=depth)
    frozen = first_layers(base, depth)
    batch = train_batch(cfg, 4, 1024, seed=3)

    def tree(r, seed):
        spec = MokaSpec.avt(rank=r, dropout_rate=0.05).with_bf16_dots() \
            .with_fused_dropout().with_flash_rank_attn()
        g = torch.Generator(device="cuda").manual_seed(seed)
        adapters = llama.init_moka_adapters(g, cfg, spec, device="cuda")
        for p in adapters["layers"].values():
            p["b"].normal_(0.0, 0.02, generator=g)
        return spec, {"adapters": adapters}

    spec, trainable = tree(rank, 40)
    log(f"  (c) LLaMA-2-7B widths cut to {depth} of 32 layers, MokA AVT "
        f"r{rank} (M*r {3 * rank}, rank attention head_dim {rank}), phase "
        f"8's rules:")
    out = {"depth": depth, "rank": rank,
           "fused_check": check_fused_train_grads(cfg, spec, frozen,
                                                  trainable, batch)}
    log("  phase 11's rules (without bf16 dots):")
    out["rank_check"] = check_rank_train_grads(
        cfg, dataclasses.replace(spec, bf16_dots=False, fused_dropout=False),
        frozen, trainable,
        batch)
    n, n_proj = depth, 7 * depth
    calls = 2 * n_proj
    run = train_steps(cfg, spec, frozen, clone_tree(trainable), batch,
                      policy="proj_lse", n_warm=2, n_timed=1)
    want = _launches(flash_fwd=n, flash_bwd_fused=n,
                     dropout_a_fwd=2 * n_proj, dropout_a_bwd=n_proj,
                     flash_rank_fwd=calls, flash_rank_bwd_dq=calls,
                     flash_rank_bwd_dkv=calls)
    log(f"  (c) r{rank} step launches: "
        f"{ {k: v for k, v in run['launches_per_step'].items() if v} }")
    if run["launches_per_step"] != want:
        raise AssertionError(f"rank-{rank} fused step launches "
                             f"{run['launches_per_step']}, want {want}")
    out["step"] = {f"r{rank}": run}
    for r in step_ranks:
        spec_r, tr = tree(r, 40 + r)
        one = train_steps(cfg, spec_r, frozen, tr, batch, policy="proj_lse",
                          n_warm=1, n_timed=1)
        if one["launches_per_step"] != want:
            raise AssertionError(f"rank-{r} fused step launches "
                                 f"{one['launches_per_step']}, want {want}")
        out["step"][f"r{r}"] = one
        del tr
    return out


def p19_cli(work: Path, p15: dict, device: str = "cuda",
            smi: str = "") -> dict:
    """``infer --lora-r P19_CLI_RANK`` on phase 15's LLaMA-2-7B, CLIP and
    BEATs files as phase 16 reads them (int4 base, int8 head, bf16 cache),
    with rank-P19_CLI_RANK adapter files this phase writes
    (``export_torch_artifacts`` of a random tree, B non-zero, beside
    ``finetune``'s projectors), on P19_CLI_SAMPLES of phase 15's AVQA
    items: it must exit with its JSONL and launch kernel 5 (and kernel 1
    and the decode kernel) on every prefill."""
    import torch
    from moka_tpu_torch.cli import infer
    from moka_tpu_torch.models import llama, unified
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.train.checkpoint import export_torch_artifacts
    files, ft = p15["files"], p15["finetune_out"]
    lcfg = p15_configs(device != "cuda")[0]
    spec = MokaSpec.avt(rank=P19_CLI_RANK, dropout_rate=0.0)
    g = torch.Generator().manual_seed(19)
    adapters = llama.init_moka_adapters(g, lcfg, spec, device="cpu")
    for p in adapters["layers"].values():
        p["b"].normal_(0.0, 0.02, generator=g)
    out_dir = work / "p19_adapters"
    export_torch_artifacts(str(out_dir), {"adapters": adapters})
    del adapters
    items = json.loads(Path(files["data_avqa"]).read_text())
    ann = work / "p19_avqa.json"
    ann.write_text(json.dumps(items[:P19_CLI_SAMPLES]))
    pad_to = 1024 if device == "cuda" else 256
    argv = ["--llama-ckpt", str(files["llama"]),
            "--clip-ckpt", str(files["clip"]),
            "--model-preset", "7b" if device == "cuda" else "tiny",
            "--pad-to", str(pad_to), "--device", device,
            "--tokenizer-json", str(files["data_tokenizer"]),
            "--beats-ckpt", str(files["beats"]),
            "--adapter-ckpt", str(out_dir / "adapter_model.bin"),
            "--non-lora-ckpt", str(ft / "non_lora_trainables.bin"),
            "--quantize-base", "4", "--quantize-head", "8",
            "--max-new-tokens", str(P16_NEW_TOKENS),
            "--lora-r", str(P19_CLI_RANK),
            "--annotation", str(ann), "--batch-size", "8",
            "--output-dir", str(work / "p19_infer")]
    n = lcfg.n_layers
    want = _launches() if device != "cuda" else _launches(
        flash_fwd=n, moka_delta_fwd=7 * n, **decode_launches(
            lcfg, pad_to + P16_NEW_TOKENS, P16_NEW_TOKENS))
    log(f"  (d) infer {' '.join(argv)}")
    calls: list = []
    t0 = time.perf_counter()
    with per_generate(unified, device, calls):
        result = infer.main(argv)
    wall = time.perf_counter() - t0
    rows = [json.loads(x) for x in Path(result).read_text().splitlines()]
    launches = [c["launches"] for c in calls]
    log(f"  (d) infer --lora-r {P19_CLI_RANK}: exit with {len(rows)} rows in "
        f"{wall:.1f} s, {len(calls)} generate calls, launches "
        f"{[{k: v for k, v in c.items() if v} for c in launches]}; {smi}")
    if len(rows) != P19_CLI_SAMPLES or not calls or \
            any(c != want for c in launches):
        raise AssertionError(f"infer --lora-r {P19_CLI_RANK}: {len(rows)} rows, "
                             f"launches {launches}, want {want}")
    return {"rank": P19_CLI_RANK, "rows": len(rows), "wall_s": wall,
            "launches_per_generate": launches[0],
            "first_prediction": rows[0]["predict"]}


def p19_records_launches(records, serving, training, phase=19) -> None:
    """Each phase-19 (or 20) record's launches: those of its kernel in the
    phase's main-path run at its rank (kernel 5: the serving prefill;
    kernels 6-7 and R1-R3: a training step), None where no main path runs
    it (kernels 6-7 at M*r 256), with ``launches_path`` saying which run
    counted."""
    by_rank = {k: v["generate_launches"] for k, v in serving.items()}
    steps = {int(k[1:]): v["launches_per_step"]
             for k, v in training["step"].items()}
    for rec in records:
        name = rec["name"]
        if name.startswith("moka_delta_fwd_"):
            key = name[len("moka_delta_fwd_"):]
            counts = by_rank[key]
            if rec["instance_rank"] > 64:  # the wide path: each launch
                rec["launches_by_kernel"] = {
                    k: int(counts[k]) for k in ("moka_delta_wide_down",
                                                "moka_delta_wide_up",
                                                "flash_rank_fwd")}
                rec["launches"] = int(counts["moka_delta_wide_down"])
                what = "the down-product launches (as many up products)"
            else:
                rec["launches"] = int(counts["moka_delta_fwd"])
                what = "the moka_delta_fwd launches"
            rec["launches_path"] = f"phase {phase} (b) {key} " \
                                   f"greedy_generate: {what}"
            continue
        if name.startswith("dropout_a_"):
            kernel, mr = name.rsplit("_mr", 1)
            rank = next((r for r in steps if 3 * r == int(mr)), None)
            why = f"M*r {mr} is not three modalities at a stepped rank"
        else:
            kernel, hd = name.rsplit("_hd", 1)
            rank = int(hd) if int(hd) in steps else None
            why = f"head_dim {hd} is not a stepped rank"
        if rank is None:  # (M*r 256: rank 64 with four modalities)
            rec["launches"] = None
            rec["launches_path"] = f"none: no phase-{phase} step runs it " \
                                   f"({why})"
        else:
            rec["launches"] = int(steps[rank][kernel])
            rec["launches_path"] = f"phase {phase} (c) r{rank} fused step"


# ------------------------------------------------------------------ phase 20

P20_RANKS = (65, 96, 128, 256, 512)  # kernel 5, AVT (M 3): the wide path
P20_VT_RANK = 128                     # and VT (M 2)
P20_MOKA_M4 = 128  # kernel 5 with four modalities (three attending)
P20_MOKA_F32 = 128  # kernel 5 on fp32 x
P20_DROP_MRS = (195, 288, 384, 768, 1536)  # kernels 6-7: ranks 65, 96,
                                           # 128, 256, 512 x 3 modalities
P20_RANK_DIMS = (65, 96, 128, 256, 512)  # R1-R3: the wide kernels
P20_SERVED = (128,)  # the rank phase 4's base serves in full (logits rule)
P20_STEP = (128, 8)  # the fused training step: rank, layers (a depth cut)
P20_RING = (2, 2048, (4, 128))  # (d): layers, L, MokA ranks (the
                                # persistent kernel's and the wide path's)
P20_LIMIT_S = 90  # the phase's wall, (a)-(d), at most
P20_RING_TOL = (2.5e-4, 0.1)  # (d)'s loss (relative) and adapter gradients
                              # (relative L2, per projection) against one
                              # process at P20_RING's 2 layers: ~4x and ~3x
                              # the sound runs' largest gaps (5.81e-05 and
                              # 3.24e-02, PERF.md §6); a ring whose
                              # second shard gets no gathered keys
                              # (``keys_kept_home``) must fail it


def p20_moka_shapes() -> dict:
    """Kernel 5's other cases past rank 64 against the plain version
    (``check_moka``): four modalities (three attending) at P20_MOKA_M4,
    fp32 x with a question mask with gaps at P20_MOKA_F32, and a question
    span of 700 keys at rank 128 (R1 walks every key of it); max|err| by
    the rank's record."""
    import torch
    x, a, bm, mod, qm, spec = moka_inputs(4, 500, 1024, 2048, "avt",
                                          torch.bfloat16, 21, P20_MOKA_M4)
    spec = dataclasses.replace(spec, num_modalities=4,
                               attn_modalities=(1, 2, 3))
    a = torch.cat([a, a[2:]]).contiguous()
    mod = torch.cat([mod, mod[2:]]).contiguous()
    errs = {f"avt_r{P20_MOKA_M4}": check_moka(
        f"M 4 r{P20_MOKA_M4} bf16 1024->2048", x, a, bm, mod, qm, spec)}
    errs[f"avt_r{P20_MOKA_F32}_fp32"] = check_moka(
        f"fp32 x r{P20_MOKA_F32} 512->1024, question gaps",
        *moka_inputs(2, 200, 512, 1024, "avt", torch.float32, 23,
                     P20_MOKA_F32, qspans=MOKA_SPLIT_Q))
    d = check_moka("r128 bf16 1024->1024, 700 question keys",
                   *moka_inputs(2, 900, 1024, 1024, "avt", torch.bfloat16,
                                25, 128, qspans=((100, 800),)))
    errs["avt_r128"] = max(errs["avt_r128"], d)
    return errs


@contextlib.contextmanager
def keys_kept_home():
    """A fault planted in kernel 5 under the ring: every rank's gathered
    question keys are zero in the other shards' rows, so a shard attends
    only to its own keys (on P20_RING's batch the question sits in the
    first shard: the second gets none).  The gather itself still runs on
    every rank (a collective)."""
    import torch.distributed as dist
    from moka_tpu_torch.models import llama
    fused = llama.moka_delta_fused

    def faulty(*args, gather_keys=None, **kw):
        def gather(t):
            full = gather_keys(t)
            n, i = t.shape[1], dist.get_rank()
            kept = full.new_zeros(full.shape)
            kept[:, i * n:(i + 1) * n] = full[:, i * n:(i + 1) * n]
            return kept
        return fused(*args, gather_keys=gather if gather_keys else None,
                     **kw)

    llama.moka_delta_fused = faulty
    try:
        yield
    finally:
        llama.moka_delta_fused = fused


def p20_wide_mutants() -> None:
    """Kernel 5's wide path launched as each MOKA_WIDE_MUTANTS fault must
    fail ``check_moka`` at rank 512 (the question span [2, 130)) or on
    ``p20_moka_shapes``' 700-key case at rank 128; R1 past head_dim 64
    launched as each RANK_WIDE_MUTANTS fault must fail ``check_rank`` on
    the key layouts (RANK_LAYOUTS: a span of 750 keys, six tiles) at head
    dims 128 and 512, or kernel 5 on the 700-key case."""
    import torch

    def moka_cases(what):
        check_moka(f"mutant ({what}) r512 bf16 1024->1024",
                   *moka_inputs(2, 300, 1024, 1024, "avt", torch.bfloat16,
                                26, 512))
        check_moka(f"mutant ({what}) r128 bf16 1024->1024, 700 question "
                   f"keys", *moka_inputs(2, 900, 1024, 1024, "avt",
                                         torch.bfloat16, 25, 128,
                                         qspans=((100, 800),)))

    for what in MOKA_WIDE_MUTANTS:
        with swapped_library("moka_delta_fwd", MUTANTS["moka_delta_fwd"][what]):
            must_fail(f"kernel 5 wide-path mutant ({what})",
                      lambda: moka_cases(what))
    for what in RANK_WIDE_MUTANTS:
        with swapped_library("flash_rank", MUTANTS["flash_rank"][what]):
            must_fail(f"R1 wide mutant ({what})", lambda: (
                [check_rank(f"mutant ({what}) hd {hd} key layouts",
                            *rank_case(4, 1024, hd=hd, seed=3 + hd,
                                       spans=RANK_LAYOUTS))
                 for hd in (128, 512)], moka_cases(what)))


def p20_ring(rank: int, device: str, tiny: bool) -> dict:
    """(d), in phase 17's world: kernel 5 under the context-parallel ring.
    ``make_llama_moka_loss(use_fused_moka=True, context_parallel=...)``
    (flash attention, full remat, chunked CE) at LLaMA-2-7B's widths cut
    to P20_RING's layers, b 1 at its L, for each of its MokA ranks: each
    rank's fused delta attends to the question keys of both shards
    (gathered), its loss and adapter gradients held against rank 0's one
    process (P20_RING_TOL), and kernel 5's launches counted on every rank
    (7 calls a layer, twice under remat: ``moka_launches``); then the ring
    with ``keys_kept_home``'s fault, which must fail the same check."""
    import torch.distributed as dist
    from moka_tpu_torch.core.rng import DropoutKey
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.train.objectives import make_llama_moka_loss
    layers, L, ranks = P20_RING
    cfg = dataclasses.replace(p17_configs(tiny)[0], n_layers=layers)
    if tiny:  # the CPU rehearsal: the plain versions at either rank
        L, ranks = 64, ranks[-1:]
    n = dist.get_world_size()
    mesh = _seq_mesh()
    out = {}

    def gaps(got, ref):
        return abs(got[0] - ref[0]) / abs(ref[0]), \
            {p: rel(got[1][p], ref[1][p]) for p in PROJS}

    def within(dloss, gap) -> bool:
        return dloss <= P20_RING_TOL[0] and \
            max(gap.values()) <= P20_RING_TOL[1]

    for r in ranks:
        spec = MokaSpec.avt(rank=r, dropout_rate=0.05)
        frozen, adapters = build_model(cfg, spec, seed=20 + r, device=device)
        trainable = {"adapters": adapters}
        batch = train_batch(cfg, 1, L, seed=21, device=device)
        key = DropoutKey(22)

        def loss(ring=True):
            return make_llama_moka_loss(
                cfg, spec, remat=True, use_flash=True, fused_loss=True,
                ce_chunk=128, use_fused_moka=True,
                context_parallel=(mesh, "seq") if ring else None)

        ref = None
        if rank == 0:
            ref = _grads(loss(ring=False), frozen, trainable, batch, key)
        dist.barrier()
        _sync(device)
        _zero_counts()
        t0 = time.perf_counter()
        got = _grads(loss(), frozen, trainable, batch, key)
        _sync(device)
        ring_ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        want = _launches(flash_fwd=2 * n * layers, flash_bwd_dq=n * layers,
                         flash_bwd_dkv=n * layers,
                         **moka_launches(spec, 2 * 7 * layers, ring=True)) \
            if device == "cuda" else _launches()
        if counts != want:
            raise AssertionError(f"rank {rank}: kernel 5 under the ring, "
                                 f"MokA r{r}: launches {counts}, want {want}")
        with keys_kept_home():
            bad = _grads(loss(), frozen, trainable, batch, key)
        rec = {"launches": counts, "ring_ms": ring_ms, "loss": got[0]}
        if rank == 0:
            dloss, gap = gaps(got, ref)
            bad_loss, bad_gap = gaps(bad, ref)
            rec.update(one_loss=ref[0], grad_rel_l2=gap, loss_rel=dloss,
                       fault={"loss_rel": bad_loss, "grad_rel_l2": bad_gap})
            log(f"  (d) kernel 5 under the ring over {n} ranks, MokA r{r}, "
                f"{layers} layers, b 1 L {L}: loss {got[0]:.6f} vs one "
                f"process {ref[0]:.6f} (rel {dloss:.2e}); adapter gradients "
                f"rel L2 { {p: f'{v:.2e}' for p, v in gap.items()} } (tol "
                f"{P20_RING_TOL}); launches a rank "
                f"{ {k: v for k, v in counts.items() if v} }; with the "
                f"second shard's keys not gathered: loss rel {bad_loss:.2e}, "
                f"gradients rel L2 "
                f"{ {p: f'{v:.2e}' for p, v in bad_gap.items()} }")
            if not within(dloss, gap):
                raise AssertionError(f"kernel 5 under the ring (r{r}) is not "
                                     f"the one-process step")
            if within(bad_loss, bad_gap):
                raise AssertionError(f"kernel 5 under the ring (r{r}) with "
                                     f"the keys not gathered passed the "
                                     f"check")
        out[f"r{r}"] = rec
        del frozen, adapters, trainable, got, ref, bad
        gc.collect()
        if device == "cuda":
            import torch
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def phase20_here(cfg, base, inputs, new_tokens) -> dict:
    """Phase 20's (a)-(c), on phase 4's base: (a) kernel 5 at P20_RANKS
    (AVT) and P20_VT_RANK (VT) with ``p20_moka_shapes``, kernels 6-7 at
    P20_DROP_MRS and R1-R3 at P20_RANK_DIMS (with phase 3's key layouts)
    against their plain versions, timed; (b) a rank-128 tree served in
    full (no engine request) and one new token at each other rank; (c)
    the fused-dropout
    flash-rank step at P20_STEP.  The records' launches are their
    instances' on (b) and (c); each part's wall is logged."""
    walls, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        walls[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    records = p19_moka_records(cfg, ranks=P20_RANKS, vt_rank=P20_VT_RANK,
                               more=p20_moka_shapes())
    lap("a_kernel5")
    p20_wide_mutants()
    lap("a_mutants")
    records += p19_dropout_records(cfg, mrs=P20_DROP_MRS)
    lap("a_kernels67")
    records += p19_rank_records(dims=P20_RANK_DIMS, layouts=True)
    lap("a_rank")
    out = {"serving": p19_serving(cfg, base, inputs, new_tokens,
                                  served=P20_SERVED, ranks=P20_RANKS,
                                  vt_rank=P20_VT_RANK, engine=False)}
    lap("b")
    out["training"] = p19_training(cfg, base, step=P20_STEP, step_ranks=())
    lap("c")
    p19_records_launches(records, out["serving"], out["training"], phase=20)
    out["walls_s"] = walls
    log(f"  phase 20 walls (s): { {k: round(v, 1) for k, v in walls.items()} }")
    return records, out


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
        text = kernels.log_path(name)
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line or \
                        "setmaxnreg" in line or "C75" in line:
                    log(f"    {name}: {line.strip()}")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        philox = pool.submit(profile_port.philox_sass)  # an nvcc of its own
        sass_prefetch(kernels.SOURCES)
        check_flash_sass()
        check_ce_sass()
        check_bd_rank_sass()
        check_moka_sass()
        check_dropout_sass()
        check_decode_sass()
        PHILOX.update(philox.result()["per_call"])

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
               clip_flash_record(), *decode_records()]
    mm_prefill_checks(records, new_tokens)
    torch.cuda.empty_cache()

    log(f"[4] LLaMA-2-7B + MokA AVT r4 at full width, {cfg.n_layers} layers")
    base, adapters = build_model(cfg, spec)
    inputs = main_path_inputs(cfg, base, batch, prompt_len)
    check_logits(cfg, spec, base, adapters, inputs, new_tokens)
    timings = main_path(
        lambda n: generate(cfg, spec, base, adapters, inputs, n), batch,
        new_tokens, cfg.vocab_size,
        _launches(flash_fwd=cfg.n_layers, moka_delta_fwd=7 * cfg.n_layers,
                  **decode_launches(cfg, prompt_len + new_tokens,
                                    new_tokens)),
        f"greedy_generate b {batch} prompt {prompt_len}")
    log(f"  a rank-{OTHER_RANK} adapter tree on the same base, "
        f"with the decode paths' defaults")
    other_rank = serve_other_rank(cfg, base, inputs, new_tokens)
    log("  the decode steps through the decode kernel, on a bf16 and an "
        "int8 cache")
    paged = paged_serving(cfg, spec, base, adapters, inputs, new_tokens)

    log("[5] HTTP serving over the continuous-batching engine")
    served = serve_requests(cfg, spec, base, adapters, new_tokens=new_tokens)
    if min(served["launches"][k] for k in ("flash_fwd", "moka_delta_fwd")) \
            <= 0:
        raise AssertionError("serving did not launch the kernels")

    t19 = time.perf_counter()
    log(f"[19] MokA at any rank: (a) kernel 5 at ranks {P19_RANKS} (AVT) and "
        f"{P19_VT_RANK} (VT), kernels 6-7 at M*r {P19_DROP_MRS}, R1-R3 at "
        f"head_dim {P19_RANK_DIMS} against their plain versions; (b) phase "
        f"4's base serving rank-{P19_SERVED[0]} and rank-{P19_SERVED[1]} AVT "
        f"trees; (c) the fused step at rank {P19_STEP[0]}; (d), after phase "
        f"16, infer --lora-r {P19_CLI_RANK}")
    p19_records = [*p19_moka_records(cfg), *p19_dropout_records(cfg),
                   *p19_rank_records()]
    p19 = {"serving": p19_serving(cfg, base, inputs, new_tokens)}
    p19["training"] = p19_training(cfg, base)
    p19_records_launches(p19_records, p19["serving"], p19["training"])
    p19["phase_s"] = time.perf_counter() - t19
    log(f"  phase 19 (a)-(c) took {p19['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t20 = time.perf_counter()
    log(f"[20] MokA past rank 64: (a) kernel 5 at ranks {P20_RANKS} (AVT) "
        f"and {P20_VT_RANK} (VT), kernels 6-7 at M*r {P20_DROP_MRS}, R1-R3 "
        f"at head_dim {P20_RANK_DIMS} against their plain versions; (b) "
        f"phase 4's base serving a rank-{P20_SERVED[0]} AVT tree; (c) the "
        f"fused step at rank {P20_STEP[0]}; (d), in phase 17's world, "
        f"kernel 5 under the context-parallel ring")
    p20_records, p20 = phase20_here(cfg, base, inputs, new_tokens)
    p20["phase_s"] = time.perf_counter() - t20
    log(f"  phase 20 (a)-(c) took {p20['phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

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
    fused_check["other_specs"] = check_fused_other_specs(fcfg, frozen, batch)
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

    vcfg = vt_config()
    log(f"[14] VT (LLaVA, vt_7b_int4a8f_qh_qenc_sq8plse): phase 9's int4 "
        f"base (int8 head) and phase 12's int8 CLIP ViT-L/14 (through "
        f"kernel 1 at head_dim 64, {vcfg.select_layer} layers), the visual "
        f"Q-Former projector and MokA VT r{vcfg.spec.rank} adapters")
    log(f"  host decoders used: {', '.join(HOST_DECODERS)}; left out: none")
    vfrozen, vtrain = build_vt_stack(vcfg, qfrozen, mfrozen["clip"])
    del mfrozen, mtrain, qtrain
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) VT benchmark eval: {VT_ITEMS} MMBench items, "
        f"{VT_NEW_TOKENS} new tokens")
    vt_gen, vt_tok = vt_eval(vcfg, vfrozen, vtrain, records,
                             ROOT / "build" / "vt_eval")
    log("  (b) the micro-batch HTTP front: an image request and a text one")
    vt_http = vt_serve(vcfg, vfrozen, vtrain, vt_tok)
    log(f"  (c) VT fine-tune step: proj_lse, a8_dots full, save_q8, bf16 "
        f"dots, chunked CE on the a8 head, b 4 L 1024, "
        f"{vcfg.llama.n_layers} layers")
    vt_train = vt_steps(vcfg, vfrozen, vtrain)
    del vfrozen, vtrain, qfrozen
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[15] the training life cycle from checkpoint files: the CLIs "
        f"finetune, train_vt and pretrain at LLaMA-2-7B's full width and "
        f"depth ({torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated from the earlier phases)")
    work = ROOT / "build" / "p15"
    t15 = time.perf_counter()
    try:
        p15 = phase15(work, "cuda", smi=smi)
        p15["phase_s"] = time.perf_counter() - t15
        log(f"  phase 15 passed in {p15['phase_s']:.1f} s")
        log("[16] inference from checkpoint files: the CLIs infer (bf16 and "
            "int8 cache, the continuous HTTP server), eval_vt and score at "
            "LLaMA-2-7B's full width and depth, on phase 15's files")
        t16 = time.perf_counter()
        p16 = phase16(work, p15, "cuda", smi=smi)
        p16["phase_s"] = time.perf_counter() - t16
        log(f"  phase 16 passed in {p16['phase_s']:.1f} s")
        t19 = time.perf_counter()
        log(f"[19] (d) infer --lora-r {P19_CLI_RANK} on phase 15's files")
        p19["cli"] = p19_cli(work, p15, "cuda", smi=smi)
        p19["phase_s"] += time.perf_counter() - t19
        log(f"  phase 19 passed in {p19['phase_s']:.1f} s (its limit "
            f"{P19_LIMIT_S} s)")
        if p19["phase_s"] > P19_LIMIT_S:
            raise AssertionError(f"phase 19 took {p19['phase_s']:.1f} s, "
                                 f"past its {P19_LIMIT_S} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[17] parallelism at LLaMA-2-7B's width: (a) the base in pinned "
        f"host memory streamed a layer at a time, then {P17_RANKS} ranks on "
        f"the card for (b) the flash ring, (c) FSDP and data-parallel "
        f"steps, (d) the finetune CLI with --mesh and --host-offload "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
        f"from the earlier phases)")
    work = ROOT / "build" / "p17"
    t17 = time.perf_counter()
    try:
        p17 = phase17(work, "cuda", smi=smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    p17["phase_s"] = time.perf_counter() - t17
    log(f"  phase 17 passed in {p17['phase_s']:.1f} s")
    p20["ring"] = p17.pop("ring_fused")
    p20["phase_s"] += p17["seconds"]["ring_fused"]
    log(f"  phase 20 passed in {p20['phase_s']:.1f} s ((d): "
        f"{p17['seconds']['ring_fused']:.1f} s of rank 0 in phase 17's "
        f"world; its limit {P20_LIMIT_S} s)")
    if p20["phase_s"] > P20_LIMIT_S:
        raise AssertionError(f"phase 20 took {p20['phase_s']:.1f} s, past "
                             f"its {P20_LIMIT_S} s")

    log(f"[18] tensor parallelism on the model axis: (b) kernels 6-7 at a "
        f"column offset, every case's one process, then worlds of "
        f"{P18_WORLDS} ranks on the card for (a) LLaMA-2-7B widths on 1,1,2 "
        f"and 1,2,2, (b) the fused-dropout step on 1,1,2, (c) CodeLlama-34B "
        f"widths (GQA 8:1) on 1,1,4, (d) the int4 recipe on 1,1,2 and (e) "
        f"finetune --mesh 1,1,2 ({torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB still allocated from the earlier phases)")
    work = ROOT / "build" / "p18"
    try:
        p18 = phase18(work, "cuda", smi=smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 18 passed in {p18['phase_s']:.1f} s")

    paths = {"serving main path (greedy_generate)": timings["launches"],
             "rank-8 serving (greedy_generate)":
                 other_rank["generate_launches"],
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
             "multimodal step": mm_train["launches_per_step"],
             "VT eval (run_inference, llava.generate)":
                 vt_gen["eval_launches"],
             "VT HTTP front (serve)": vt_http["launches"],
             "VT step": vt_train["launches_per_step"],
             "finetune CLI step": p15["finetune"]["launches_per_step"],
             "train_vt CLI step": p15["train_vt"]["launches_per_step"],
             "pretrain CLI step": p15["pretrain"]["launches_per_step"],
             "paged serving, bf16 cache (greedy_generate)":
                 paged["bf16"]["launches"],
             "paged serving, int8 cache (greedy_generate)":
                 paged["int8"]["launches"],
             "infer CLI generate, bf16 cache":
                 p16["infer_bf16"]["launches_per_generate"],
             "infer CLI generate, int8 cache":
                 p16["infer_int8"]["launches_per_generate"],
             "eval_vt CLI generate": p16["eval_vt"]["launches_per_generate"],
             "flash ring step (context parallel, a rank)":
                 p17["ring"]["launches"],
             "fused-dropout data-parallel step (2,1,1, a rank)":
                 p17["mesh"]["2,1,1+fused_dropout"]["launches"],
             "tensor-parallel step (1,1,2, a rank)":
                 p18["world2"]["a/1,1,2"]["launches"],
             "tensor-parallel step (1,2,2, a rank)":
                 p18["world4"]["a/1,2,2"]["launches"],
             "tensor-parallel fused-dropout step (1,1,2, a rank)":
                 p18["world2"]["b/1,1,2"]["launches"],
             "tensor-parallel 34B-width step (1,1,4, a rank)":
                 p18["world4"]["c/1,1,4"]["launches"],
             "tensor-parallel int4 step (1,1,2, a rank)":
                 p18["world2"]["d/1,1,2"]["launches"],
             **{f"phase 19 (b) {k} greedy_generate": v["generate_launches"]
                for k, v in p19["serving"].items()},
             **{f"phase 19 (c) {k} fused step": v["launches_per_step"]
                for k, v in p19["training"]["step"].items()},
             f"infer CLI --lora-r {P19_CLI_RANK} generate":
                 p19["cli"]["launches_per_generate"],
             **{f"phase 20 (b) {k} greedy_generate": v["generate_launches"]
                for k, v in p20["serving"].items()},
             **{f"phase 20 (c) {k} fused step": v["launches_per_step"]
                for k, v in p20["training"]["step"].items()},
             **{f"phase 20 (d) kernel 5 under the ring, {k} (a rank)":
                v["launches"] for k, v in p20["ring"].items()}}
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
           "flash_fwd_hd64": "multimodal generate (unified.generate)",
           "paged_decode": "paged serving, bf16 cache (greedy_generate)",
           "paged_decode_int8": "paged serving, int8 cache (greedy_generate)"}
    for rec in records:
        rec["launches"] = int(paths[own[rec["name"]]][rec["name"]])
        rec["launches_path"] = own[rec["name"]]
        rec["launches_by_path"] = {p: c.get(rec["name"], 0) for p, c in
                                   paths.items()}
    records += p19_records  # their launches: their instances' (phase 19)
    records += p20_records  # and phase 20's
    log(json.dumps({"main_path": timings, "rank8_serving": other_rank,
                    "serving": served,
                    "train_check": train_check, "train": train,
                    "long_context": long_step, "fused_check": fused_check,
                    "fused_train": fused, "policy_ladder": ladder,
                    "quant_check": quant_check, "quant_train": quant,
                    "boft": boft, "rank_check": rank_check,
                    "rank_train": rank, "mm_generate": mm_gen,
                    "mm_train": mm_train, "vt_generate": vt_gen,
                    "vt_http": vt_http, "vt_train": vt_train,
                    "paged_serving": paged, "p15": p15_summary(p15),
                    "p16": p16_summary(p16), "p17": p17, "p18": p18,
                    "p19": p19, "p20": p20}))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
