"""VT (LLaVA-Instruct) fine-tune driver (port of
``moka_tpu/cli/train_vt.py``).

Builds the bi-modal model from LLaMA-2 + CLIP, loads the stage-1
``visual_pretrain.bin`` into the projector, trains projector + dual-adapter
MokA (r=4, attn_weight 0.05, lr 1e-4, 2 epochs, global batch 32) and saves
the trainable state as ``model.safetensors`` in the reference schema.

    python -m moka_tpu_torch.cli.train_vt --llama-ckpt DIR --clip-ckpt DIR \\
        --tokenizer-json tokenizer.json --data-json llava_instruct.json \\
        --image-root coco/train2017 --output-dir runs/vt

On the card unless ``--device cpu``; several ranks under torchrun,
``--mesh`` and ``--host-offload`` as in ``cli/finetune.py`` (each rank
feeds its slice of every global batch, the ranks of one model group
the same slice).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moka-train-vt")
    p.add_argument("--llama-ckpt")
    p.add_argument("--clip-ckpt")
    p.add_argument("--tokenizer-json")
    p.add_argument("--visual-pretrain", help="stage-1 projector ckpt")
    p.add_argument("--data-json", help="LLaVA-Instruct-style json")
    p.add_argument("--image-root", help="COCO train2017 root")
    p.add_argument("--output-dir", default="runs/train_vt")
    p.add_argument("--attn-weight", type=float, default=0.05)
    p.add_argument("--lora-r", type=int, default=4)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-dropout", type=float, default=0.05)
    p.add_argument("--question-window", type=int, default=0,
                   help="static rank-attention key window (tokens); "
                        "0 = full-length keys")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--global-batch", type=int, default=32)
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--mesh", default="fsdp")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-steps", type=float, default=0,
                   help="absolute steps, or a 0-1 fraction of total steps")
    p.add_argument("--quantize-base", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="int8/int4 weight-only frozen LLaMA base "
                        "(QLoRA-style); bare flag = int8")
    p.add_argument("--quantize-head", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="with --quantize-base: also quantize the frozen "
                        "lm_head")
    p.add_argument("--remat-policy", default="auto",
                   help="per-layer remat policy (models.llama."
                        "REMAT_POLICIES); 'auto' = 'qkvod'")
    p.add_argument("--host-offload", action="store_true",
                   help="frozen base in pinned host memory (not ported: "
                        "refused)")
    p.add_argument("--model-preset", choices=["7b", "tiny"], default="7b",
                   help="'tiny' = small random-init model for smoke tests "
                        "(no checkpoints needed)")
    p.add_argument("--a8-dots", nargs="?", const=True, default=False,
                   choices=[True, False, "full"],
                   help="dynamic per-token int8 activations on the "
                        "quantized frozen-base projections (W4A8/W8A8); "
                        "'full' also quantizes the backward cotangent")
    p.add_argument("--quantize-encoders", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="weight-only int8/int4 on the frozen CLIP tower")
    p.add_argument("--save-q8", action="store_true",
                   help="int8-quantize the remat save set "
                        "(quant.q8_roundtrip)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def iter_vt_samples(data_json: str, image_root: str, tokenize, pad_id: int,
                    image_placeholder_id: int, num_image_tokens: int = 32,
                    image_size: int = 224):
    """LLaVA-Instruct conversations -> single-turn VT samples: multi-turn
    split, <image> x num_image_tokens expansion, everything after the chat
    prompt supervised."""
    from moka_tpu_torch.data.datasets import llama2_chat_prompt
    from moka_tpu_torch.data.video import load_image
    from moka_tpu_torch.data.vt_dataset import build_vt_sample

    with open(data_json) as f:
        rows = json.load(f)
    for row in rows:
        convs = row.get("conversations", [])
        image_path = os.path.join(image_root, row.get("image", ""))
        for i in range(0, len(convs) - 1, 2):
            if convs[i].get("from") != "human":
                continue
            user = convs[i]["value"].replace(
                "<image>", "<image>" * num_image_tokens, 1)
            answer = convs[i + 1]["value"]
            prompt = llama2_chat_prompt(user) + " " + answer + "</s>"
            ids = np.asarray(tokenize.encode(prompt), np.int64)
            n_prompt = len(tokenize.encode(llama2_chat_prompt(user)))
            labels = np.full(len(ids), -100, np.int64)
            labels[n_prompt:] = ids[n_prompt:]
            sample = build_vt_sample(ids, labels, image_placeholder_id,
                                     pad_id, num_image_tokens)
            sample["pixel_values"] = load_image(image_path, size=image_size)
            yield sample


def main(argv=None):
    """Train, write ``model.safetensors`` and export; returns the
    ``Trainer`` and the batch generator."""
    args = build_argparser().parse_args(argv)
    import dataclasses

    import torch

    from moka_tpu_torch.cli.finetune import (describe_placement,
                                             init_distributed,
                                             make_mesh_from_flag, place_llama,
                                             resolve_remat, to_device)
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.parallel.mesh import (data_parallel_index,
                                              host_local_batch_size,
                                              rank_device)
    from moka_tpu_torch.data.tokenizer import load_tokenizer
    from moka_tpu_torch.data.vt_dataset import collate_vt
    from moka_tpu_torch.models import llava
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.train import checkpoint as ckpt
    from moka_tpu_torch.train import import_torch as imp
    from moka_tpu_torch.train.trainer import Trainer, process_rank

    init_distributed(args.device)
    dev = rank_device(args.device)
    mesh = make_mesh_from_flag(args.mesh)
    tok = load_tokenizer(args.tokenizer_json)
    if args.model_preset == "tiny":
        base = llava.LlavaConfig.tiny()
        cfg = dataclasses.replace(
            base,
            llama=dataclasses.replace(base.llama, vocab_size=max(
                tok.vocab_size, base.llama.vocab_size)),
            spec=MokaSpec.vt(rank=args.lora_r, lora_alpha=args.lora_alpha,
                             attn_weight=args.attn_weight,
                             dropout_rate=args.lora_dropout))
    else:
        cfg = llava.LlavaConfig.vt_7b(vocab_size=tok.vocab_size,
                                      attn_weight=args.attn_weight,
                                      rank=args.lora_r,
                                      lora_alpha=args.lora_alpha,
                                      dropout_rate=args.lora_dropout)
    if args.question_window:
        cfg = dataclasses.replace(
            cfg, spec=cfg.spec.with_question_window(args.question_window))
    remat_policy = resolve_remat(args.remat_policy, args.model_preset)
    t0 = time.perf_counter()
    if args.llama_ckpt:
        if args.quantize_base:
            from moka_tpu_torch.ops.quant import import_llama_quantized
            llama_params = import_llama_quantized(
                imp.load_torch(args.llama_ckpt), cfg.llama,
                bits=args.quantize_base,
                head_bits=args.quantize_head or None, device=dev)
        else:
            llama_params = imp.import_llama(imp.load_torch(args.llama_ckpt),
                                            cfg.llama, device=dev)
        frozen = {
            "llama": llama_params,
            "clip": imp.import_clip(imp.load_torch(args.clip_ckpt),
                                    cfg.clip, dtype=torch.bfloat16,
                                    device=dev),
        }
    else:
        # random init (smoke / debug mode, like finetune without ckpts)
        frozen = llava.init_frozen(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
            dtype=torch.float32 if args.model_preset == "tiny"
            else torch.bfloat16)
        if args.quantize_base:
            from moka_tpu_torch.ops.quant import quantize_llama_base
            frozen["llama"] = quantize_llama_base(
                frozen["llama"], bits=args.quantize_base,
                head_bits=args.quantize_head or None)
    if args.quantize_encoders:
        from moka_tpu_torch.ops.quant import quantize_encoder
        frozen["clip"] = quantize_encoder(frozen["clip"],
                                          bits=args.quantize_encoders)
    frozen["llama"], host_stream = place_llama(mesh, frozen["llama"],
                                               args.host_offload)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    if process_rank() == 0:
        print(f"[train_vt] base q: {describe_placement(frozen['llama'])}; "
              f"frozen trees ready in {time.perf_counter() - t0:.2f} s "
              f"(checkpoint read + import + quantize + placement)",
              flush=True)
    trainable = llava.init_trainable(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    if args.visual_pretrain:
        sd = imp.load_torch(args.visual_pretrain)
        trainable = imp.import_vt_trainable(sd, cfg, trainable, device=dev)

    image_ph = tok.token_to_id["<image>"]
    samples = list(iter_vt_samples(args.data_json, args.image_root,
                                   tok.as_tokenize(), tok.pad_id, image_ph,
                                   cfg.projector.num_query_tokens,
                                   image_size=cfg.clip.image_size))
    per_step = args.global_batch
    total_steps = max(len(samples) // per_step, 1) * args.epochs
    tcfg = TrainConfig(learning_rate=args.learning_rate,
                       num_epochs=args.epochs, global_batch_size=per_step,
                       save_every_steps=args.save_steps,
                       output_dir=args.output_dir, seed=args.seed,
                       remat_policy=remat_policy)
    big = args.model_preset != "tiny"
    trainer = Trainer(llava.llava_loss(cfg, remat=True, use_flash=big,
                                       fused_loss=big,
                                       remat_policy=remat_policy,
                                       a8_dots=args.a8_dots,
                                       save_q8=args.save_q8, mesh=mesh,
                                       host_stream=host_stream),
                      trainable, frozen, tcfg, total_steps, mesh=mesh)
    per_rank = host_local_batch_size(per_step, mesh)
    # the ranks of one model group feed the same slice
    first = data_parallel_index(mesh)[0] * per_rank

    def batches():
        rng = np.random.default_rng(args.seed)
        for _ in range(args.epochs):
            order = rng.permutation(len(samples))
            for i in range(0, len(order) - per_step + 1, per_step):
                # every rank draws the same order and keeps its slice
                items = [samples[int(j)] for j in
                         order[i + first:i + first + per_rank]]
                pix = np.stack([s["pixel_values"] for s in items])
                batch = collate_vt(
                    [{k: v for k, v in s.items() if k != "pixel_values"}
                     for s in items], tok.pad_id, pad_to=args.pad_to,
                    max_question_tokens=args.question_window or None,
                    question_overflow="disable")
                batch["pixel_values"] = pix
                yield to_device(batch, dev)

    state = trainer.train(batches())
    if process_rank() == 0:
        ckpt.save_vt_safetensors(
            os.path.join(args.output_dir, "model.safetensors"),
            state.params, cfg)
    ckpt.barrier()
    trainer.finalize()
    return trainer, batches


if __name__ == "__main__":
    main()
