"""Batched inference driver, AVQA / AVE (port of ``moka_tpu/cli/infer.py``).

Rebuilds the model with the fine-tuned artifacts (the torch-format
``adapter_model.bin`` + ``non_lora_trainables.bin`` that ``finetune``
exports), generates greedily (or sampled) over the strided shard of this
process (the ``torch.distributed`` rank, or 0 without a group) and writes
its JSONL; or serves HTTP requests, micro-batched or (``--continuous``)
through the continuous-batching ``DecodeEngine``.

    python -m moka_tpu_torch.cli.infer --llama-ckpt DIR --clip-ckpt DIR \\
        --beats-ckpt FILE.pt --tokenizer-json tokenizer.model \\
        --adapter-ckpt run/adapter_model.bin \\
        --non-lora-ckpt run/non_lora_trainables.bin \\
        --annotation avqa_test.json --output-dir runs/infer

It runs on one device, the card unless ``--device cpu``.  On the card
the prefill takes the flash kernel and, for ``--lora-r`` 1 to 64, the
fused MokA kernel (a larger rank the unfused delta); the decode steps
take the decode kernel where ``eval.decode.paged_decode_auto`` says so,
on a bf16 cache or (``--kv-quant``) an int8 one.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moka-infer")
    p.add_argument("--llama-ckpt")
    p.add_argument("--clip-ckpt")
    p.add_argument("--beats-ckpt")
    p.add_argument("--tokenizer-json")
    p.add_argument("--adapter-ckpt", help="adapter_model.bin")
    p.add_argument("--non-lora-ckpt", help="non_lora_trainables.bin")
    p.add_argument("--task", choices=["avqa", "ave"], default="avqa")
    p.add_argument("--annotation")
    p.add_argument("--data-root")
    p.add_argument("--output-dir", default="runs/infer")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=500)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature; 0 = greedy (the reference "
                        "eval recipe). Serving also accepts per-request "
                        "temperature/top_k/top_p/max_new_tokens in the "
                        "HTTP body (max_new_tokens clamped to the server's "
                        "--max-new-tokens)")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed; each batch's generator is seeded "
                        "from it and a running counter, so samples vary "
                        "across batches and runs repeat per seed")
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--lora-r", type=int, default=4)
    p.add_argument("--blc-weight", type=float, default=1.0)
    p.add_argument("--question-window", type=int, default=0,
                   help="static rank-attention key window at prefill "
                        "(tokens); 0 = full-length keys")
    p.add_argument("--quantize-base", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="int8/int4 weight-only frozen base (QLoRA-style); "
                        "bare flag = int8")
    p.add_argument("--quantize-head", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="with --quantize-base: also quantize the frozen "
                        "lm_head (halves the per-decode-step head read; "
                        "logits stay fp32)")
    p.add_argument("--kv-quant", action="store_true",
                   help="store the decode KV cache int8 with per-(token, "
                        "head) scales: half the cache bytes a decode step "
                        "reads")
    p.add_argument("--model-preset", choices=["7b", "tiny"], default="7b")
    p.add_argument("--continuous", action="store_true",
                   help="with --serve: continuous batching (slot-based "
                        "decode engine; requests join free lanes mid-"
                        "stream) instead of micro-batch windows")
    p.add_argument("--steps-per-dispatch", type=int, default=8,
                   help="decode steps a dispatch in the continuous engine "
                        "(admission latency grows with it)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="decode dispatches kept in flight before the host "
                        "reads their tokens (0 disables pipelining)")
    p.add_argument("--serve", action="store_true",
                   help="start the micro-batching HTTP server instead of "
                        "offline JSONL inference")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def _generator(seed: int, counter: int, device):
    """The generator of one batch: ``seed`` and the batch counter, as JAX
    folds the counter into ``key(seed)``."""
    import torch
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + counter)


def _assemble(tok, prompt: str, n_video_tokens: int, pad_to: int):
    """One text(+image) prompt as a padded batch row."""
    from moka_tpu_torch.data import assembler as asmb
    t = tok.as_tokenize()
    ids = np.asarray(t.encode(prompt), np.int64)
    return asmb.assemble_sample(ids, np.full(len(ids), -100, np.int64),
                                t.token_to_id, t.pad_id,
                                n_video_tokens=n_video_tokens,
                                n_audio_tokens=0)


def make_serve_generate_fn(tok, trainable, frozen, cfg, *, pad_to: int,
                           max_new_tokens: int, temperature: float = 0.0,
                           top_k: int = 0, top_p: float = 1.0,
                           seed: int = 0, device=None):
    """Micro-batched serving generate fn (items -> texts).

    Honors per-request ``temperature``/``top_k``/``top_p`` from the HTTP
    body as per-row values (falling back to the server-wide flags) and
    per-request ``max_new_tokens`` by truncating each row of the
    batch-static decode (clamped to the server's ``--max-new-tokens``).
    Each batch's generator comes from ``seed`` and a running counter.
    ``device``: where the batch goes (default: the frozen LLaMA's)."""
    import itertools
    import torch
    from moka_tpu_torch.data import assembler as asmb
    from moka_tpu_torch.models import unified

    nq = cfg.vl_projector.num_query_tokens
    dev = frozen["llama"]["embed"].device if device is None else device
    batch_counter = itertools.count()

    def generate_texts(items):
        assembled = [_assemble(tok, it["prompt"],
                               nq if "image" in it else 0, pad_to)
                     for it in items]
        batch = asmb.pad_batch(assembled, tok.pad_id, pad_to=pad_to)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if all("image" in it for it in items):
            batch["video"] = torch.as_tensor(
                np.stack([it["image"] for it in items]), device=dev)[:, None]
        temps = torch.tensor([float(it.get("temperature", temperature))
                              for it in items], dtype=torch.float32,
                             device=dev)
        topks = torch.tensor([int(it.get("top_k", top_k)) for it in items],
                             dtype=torch.int64, device=dev)
        topps = torch.tensor([float(it.get("top_p", top_p))
                              for it in items], dtype=torch.float32,
                             device=dev)
        mnts = [min(int(it.get("max_new_tokens", max_new_tokens)),
                    max_new_tokens) for it in items]
        toks_out = unified.generate(
            trainable, frozen, cfg, batch, max_new_tokens=max_new_tokens,
            eos_id=tok.eos_id, pad_id=tok.pad_id, temperature=temps,
            top_k=topks, top_p=topps,
            generator=_generator(seed, next(batch_counter), dev))
        return [tok.decode([x for x in row[:n] if x != tok.pad_id])
                for row, n in zip(toks_out.tolist(), mnts)]

    return generate_texts


def build_model(args):
    """(tokenizer, config, trainable, frozen) from the flags: the frozen
    towers from their checkpoints (random from seed 0 without
    ``--llama-ckpt``), the trainable tree from seed 0 with the artifacts
    loaded over it."""
    import dataclasses

    import torch

    from moka_tpu_torch.core.device import resolve_device
    from moka_tpu_torch.data.tokenizer import load_tokenizer
    from moka_tpu_torch.models import unified
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.train import import_torch as imp

    dev = resolve_device(args.device)
    tok = load_tokenizer(args.tokenizer_json)
    spec = MokaSpec.avt(rank=args.lora_r, blc_weight=args.blc_weight,
                        dropout_rate=0.0)
    if args.question_window:
        spec = spec.with_question_window(args.question_window)
    if args.model_preset == "tiny":
        base = unified.UnifiedConfig.tiny(spec=spec)
        cfg = dataclasses.replace(base, llama=dataclasses.replace(
            base.llama, vocab_size=max(tok.vocab_size,
                                       base.llama.vocab_size)))
    else:
        cfg = unified.UnifiedConfig.avt_7b(vocab_size=tok.vocab_size,
                                           spec=spec)

    if args.llama_ckpt:
        if args.quantize_base:
            from moka_tpu_torch.ops.quant import import_llama_quantized
            llama_params = import_llama_quantized(
                imp.load_torch(args.llama_ckpt), cfg.llama,
                bits=args.quantize_base,
                head_bits=args.quantize_head or None, device=dev)
        else:
            llama_params = imp.import_llama(
                imp.load_torch(args.llama_ckpt), cfg.llama, device=dev)
        frozen = {
            "llama": llama_params,
            "clip": imp.import_clip(imp.load_torch(args.clip_ckpt),
                                    cfg.clip, dtype=torch.bfloat16,
                                    device=dev),
        }
        sd, bcfg = imp.load_torch(args.beats_ckpt)
        frozen["beats"] = imp.import_beats(
            sd, imp.beats_config_from_ckpt(bcfg), dtype=torch.bfloat16,
            device=dev)
    else:
        frozen = unified.init_frozen(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
            dtype=torch.float32 if args.model_preset == "tiny"
            else torch.bfloat16)

    trainable = unified.init_trainable(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    if args.adapter_ckpt:
        trainable["adapters"] = imp.import_moka_adapters_avt(
            imp.load_torch(args.adapter_ckpt), cfg.llama,
            spec.num_modalities, spec.rank, device=dev)
    if args.non_lora_ckpt:
        sd = imp.load_torch(args.non_lora_ckpt)
        # wrapper prefixes vary by stage (base_model.model.model. / model.):
        # match by substring, as the reference's strict=False load does
        for key, kind in (("vl_projector", "visual"),
                          ("al_projector", "audio")):
            sub = imp.strip_to_submodule(sd, f"{key}.")
            if sub:
                trainable[key] = imp.import_projector(
                    sub, getattr(cfg, key), kind=kind, device=dev)
    return tok, cfg, trainable, frozen


def main(argv=None):
    """Run the driver; the offline mode returns its JSONL path."""
    args = build_argparser().parse_args(argv)
    import itertools

    import torch

    from moka_tpu_torch.data.datasets import UnifiedDataset
    from moka_tpu_torch.eval.runner import run_inference
    from moka_tpu_torch.models import unified

    tok, cfg, trainable, frozen = build_model(args)
    dev = frozen["llama"]["embed"].device

    if args.serve and args.continuous:
        # continuous batching: per-request prefill into free decode lanes
        from moka_tpu_torch.data import assembler as asmb
        from moka_tpu_torch.eval.engine import DecodeEngine
        from moka_tpu_torch.eval.server import serve_continuous
        from moka_tpu_torch.models import llama as llama_mod

        nq = cfg.vl_projector.num_query_tokens
        engine = DecodeEngine(
            frozen["llama"], trainable.get("adapters"), cfg=cfg.llama,
            spec=cfg.spec, n_slots=8,
            cache_capacity=args.pad_to + args.max_new_tokens,
            eos_id=tok.eos_id, pad_id=tok.pad_id,
            steps_per_dispatch=args.steps_per_dispatch,
            cache_dtype=frozen["llama"]["embed"].dtype,
            kv_quant=args.kv_quant, pipeline_depth=args.pipeline_depth)

        def prep(item):
            sample = _assemble(tok, item["prompt"],
                               nq if "image" in item else 0, args.pad_to)
            batch = asmb.pad_batch([sample], tok.pad_id, pad_to=args.pad_to)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            if "image" in item:
                batch["video"] = torch.as_tensor(
                    np.stack([item["image"]]), device=dev)[:, None]
            with torch.no_grad():
                embeds = unified.build_inputs_embeds(trainable, frozen, cfg,
                                                     batch)
            masks = llama_mod.MaskBundle(batch["modality_masks"],
                                         batch["question_mask"])
            return embeds, batch["attn_mask"].cpu().numpy(), masks

        def decode_txt(toks):
            return tok.decode([int(x) for x in toks
                               if x not in (tok.pad_id, tok.eos_id)])

        server = serve_continuous(engine, prep, decode_txt, port=args.port,
                                  max_new_tokens=args.max_new_tokens)
        print(f"serving (continuous) on :{server.server_address[1]}",
              flush=True)
        server.serve_forever()
        return None

    if args.serve:
        # serving mode: text(+optional image) prompts through the same model
        from moka_tpu_torch.eval.server import serve
        generate_texts = make_serve_generate_fn(
            tok, trainable, frozen, cfg, pad_to=args.pad_to,
            max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, seed=args.seed)
        server = serve(generate_texts, port=args.port)
        print(f"serving on :{server.server_address[1]}", flush=True)
        server.serve_forever()
        return None

    kw = {"avqa_annotation": args.annotation} if args.task == "avqa" else \
         {"ave_annotation": args.annotation, "ave_data_root": args.data_root}
    n_frames = 10 if args.model_preset == "7b" else 2
    ds = UnifiedDataset(tok.as_tokenize(), mode="test",
                        video_frame_nums=n_frames,
                        image_size=cfg.clip.image_size,
                        n_video_tokens=n_frames *
                        cfg.vl_projector.num_query_tokens,
                        n_audio_tokens=10 *
                        cfg.al_projector.num_query_tokens,
                        max_question_tokens=args.question_window or None,
                        **kw)
    batch_counter = itertools.count()

    def generate_fn(items):
        batch = ds.collate(items, pad_to=args.pad_to)
        meta, outputs = batch.pop("meta"), batch.pop("output")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        toks = unified.generate(
            trainable, frozen, cfg, batch,
            max_new_tokens=args.max_new_tokens, eos_id=tok.eos_id,
            pad_id=tok.pad_id, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p,
            generator=_generator(args.seed, next(batch_counter), dev),
            kv_quant=args.kv_quant)
        rows = []
        for i, t in enumerate(toks.tolist()):
            text = tok.decode([x for x in t if x != tok.pad_id])
            rows.append({**meta[i], "output": outputs[i], "predict": text})
        return rows

    path = run_inference(ds, generate_fn, args.output_dir,
                         task=args.task, batch_size=args.batch_size)
    print(f"wrote {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
