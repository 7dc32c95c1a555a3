"""VT benchmark eval driver, MMBench / MME / POPE / SEED (port of
``moka_tpu/cli/eval_vt.py``).

Rebuilds the VT model, loads the fine-tuned state (``train_vt``'s
``model.safetensors``), runs strided-sharded greedy generation, writes
this process's JSONL shard in the row schema the scorers read, then (rank
0, after every rank's shard) merges the shards and scores them.

    python -m moka_tpu_torch.cli.eval_vt --task mmbench --llama-ckpt DIR \\
        --clip-ckpt DIR --tokenizer-json tokenizer.model \\
        --model-ckpt runs/vt/model.safetensors --data mmbench_dev.tsv

One device, the card unless ``--device cpu``.  The process rank is the
``torch.distributed`` rank when a group is initialized (ranks wait for one
another at a barrier before rank 0 merges), else 0: one process needs no
group.
"""

from __future__ import annotations

import argparse

MAX_NEW = {"mmbench": 5, "mme": 50, "pope": 50, "seed": 500}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moka-eval-vt")
    p.add_argument("--task", required=True,
                   choices=["mmbench", "mme", "pope", "seed"])
    p.add_argument("--llama-ckpt")
    p.add_argument("--clip-ckpt")
    p.add_argument("--tokenizer-json")
    p.add_argument("--model-ckpt", help="model.safetensors / run dir")
    p.add_argument("--data", help="TSV / data root / json per task")
    p.add_argument("--image-root", help="SEED/POPE image root")
    p.add_argument("--output-dir", default="runs/eval_vt")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--attn-weight", type=float, default=0.05)
    p.add_argument("--model-preset", choices=["7b", "tiny"], default="7b",
                   help="'tiny' = small random-init model for smoke tests")
    p.add_argument("--max-new-tokens", type=int, default=0,
                   help="override the per-task default generation length")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 decode KV cache (half the cache bytes a "
                        "decode step reads)")
    p.add_argument("--no-score", action="store_true",
                   help="only write per-rank shards (skip the merge and "
                        "score step)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def load_dataset(args, image_size: int = 224):
    from moka_tpu_torch.data.benchmarks import (MMBenchDataset, MMEDataset,
                                                POPEDataset, SEEDDataset)
    if args.task == "mmbench":
        return MMBenchDataset(args.data, image_size=image_size)
    if args.task == "mme":
        return MMEDataset(args.data, image_size=image_size)
    if args.task == "pope":
        return POPEDataset.from_hf(args.data, image_size=image_size)
    return SEEDDataset(args.data, args.image_root, image_size=image_size)


def main(argv=None):
    """Run the eval; returns the scores (rank 0), else None."""
    args = build_argparser().parse_args(argv)
    import dataclasses

    import torch
    import torch.distributed as dist

    from moka_tpu_torch.core.device import resolve_device
    from moka_tpu_torch.data.benchmarks import build_eval_batch
    from moka_tpu_torch.data.tokenizer import load_tokenizer
    from moka_tpu_torch.eval.runner import run_inference
    from moka_tpu_torch.models import llava
    from moka_tpu_torch.train import import_torch as imp
    from moka_tpu_torch.train.trainer import process_rank

    dev = resolve_device(args.device)
    tok = load_tokenizer(args.tokenizer_json)
    if args.model_preset == "tiny":
        base = llava.LlavaConfig.tiny()
        cfg = dataclasses.replace(base, llama=dataclasses.replace(
            base.llama, vocab_size=max(tok.vocab_size,
                                       base.llama.vocab_size)))
    else:
        cfg = llava.LlavaConfig.vt_7b(vocab_size=tok.vocab_size,
                                      attn_weight=args.attn_weight)
    if args.llama_ckpt:
        frozen = {
            "llama": imp.import_llama(imp.load_torch(args.llama_ckpt),
                                      cfg.llama, device=dev),
            "clip": imp.import_clip(imp.load_torch(args.clip_ckpt),
                                    cfg.clip, dtype=torch.bfloat16,
                                    device=dev),
        }
    else:
        frozen = llava.init_frozen(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
            dtype=torch.float32 if args.model_preset == "tiny"
            else torch.bfloat16)
    trainable = llava.init_trainable(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    if args.model_ckpt:
        trainable = imp.import_vt_trainable(imp.load_torch(args.model_ckpt),
                                            cfg, trainable, device=dev)

    ds = load_dataset(args, image_size=cfg.clip.image_size)
    nq = cfg.projector.num_query_tokens

    def generate_fn(items):
        batch = build_eval_batch(items, tok.as_tokenize(), nq,
                                 pad_to=args.pad_to)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        toks = llava.generate(trainable, frozen, cfg, batch,
                              max_new_tokens=args.max_new_tokens or
                              MAX_NEW[args.task],
                              eos_id=tok.eos_id, pad_id=tok.pad_id,
                              kv_quant=args.kv_quant)
        return [{**it["meta"], "answer": it["answer"],
                 "output": [tok.decode([x for x in t if x != tok.pad_id])]}
                for it, t in zip(items, toks.tolist())]

    path = run_inference(ds, generate_fn, args.output_dir, task=args.task,
                         batch_size=args.batch_size)
    print(f"wrote {path}", flush=True)
    if args.no_score:
        return None

    # every rank's shard is written before rank 0 merges (the reference's
    # dist.barrier before merging, mmbench.py:614-615)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    if process_rank() != 0:
        return None
    import json
    import os
    from moka_tpu_torch.eval.scorers import mme, options
    merged = options.merge_rank_files(args.output_dir)
    if args.task in ("mmbench", "seed"):
        scores = options.score_option_file(merged)
    elif args.task == "pope":
        scores = options.score_yesno_file(merged)
    else:
        scores = mme.score_file(merged)
    out_json = os.path.join(args.output_dir, f"scores_{args.task}.json")
    with open(out_json, "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps(scores, indent=2))
    print(f"scored -> {out_json}", flush=True)
    return scores


if __name__ == "__main__":
    main()
