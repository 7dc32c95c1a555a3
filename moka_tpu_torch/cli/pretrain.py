"""Stage-1 projector pretraining driver, captioning (port of
``moka_tpu/cli/pretrain.py``).

The decoder runs without adapters; the backbone and lm_head are frozen and
the projectors are trained.  The final export is the stage-1 projector
state (``non_lora_trainables.bin`` under ``model.`` prefixes).

    python -m moka_tpu_torch.cli.pretrain --llama-ckpt DIR --clip-ckpt DIR \\
        --tokenizer-json tokenizer.json --image-json captions.json \\
        --branch visual --output-dir runs/pretrain

On the card unless ``--device cpu``; several ranks under torchrun and
``--mesh`` as in ``cli/finetune.py`` (each rank feeds its slice of every
global batch, the ranks of one model group the same slice).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moka-pretrain")
    p.add_argument("--llama-ckpt")
    p.add_argument("--clip-ckpt")
    p.add_argument("--beats-ckpt")
    p.add_argument("--tokenizer-json")
    p.add_argument("--image-json")
    p.add_argument("--video-json")
    p.add_argument("--audio-json")
    p.add_argument("--branch", choices=["visual", "audio"],
                   default="visual")
    p.add_argument("--output-dir", default="runs/pretrain")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--pad-to", type=int, default=512)
    p.add_argument("--mesh", default="fsdp")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    """Train and export the stage-1 artifacts; returns the ``Trainer`` and
    the batch generator."""
    args = build_argparser().parse_args(argv)
    import torch

    from moka_tpu_torch.cli.finetune import (init_distributed,
                                             make_mesh_from_flag, place_llama,
                                             to_device)
    from moka_tpu_torch.core.config import TrainConfig
    from moka_tpu_torch.parallel.mesh import (data_parallel_index,
                                              host_local_batch_size,
                                              rank_device)
    from moka_tpu_torch.data import assembler as asm
    from moka_tpu_torch.data.datasets import PretrainDataset
    from moka_tpu_torch.data.tokenizer import load_tokenizer
    from moka_tpu_torch.models import unified
    from moka_tpu_torch.train import import_torch as imp
    from moka_tpu_torch.train.trainer import Trainer, process_rank

    init_distributed(args.device)
    dev = rank_device(args.device)
    # the reference pretrains the two branches in separate runs; a mixed
    # batch would need both towers and per-modality audio shapes
    if args.branch == "visual" and args.audio_json:
        raise SystemExit("--branch visual cannot take --audio-json "
                         "(run the audio branch separately, like the "
                         "reference's pretrain_audio.sh)")
    if args.branch == "audio" and (args.image_json or args.video_json):
        raise SystemExit("--branch audio cannot take --image-json/"
                         "--video-json (run the visual branch separately)")
    mesh = make_mesh_from_flag(args.mesh)
    tok = load_tokenizer(args.tokenizer_json)
    cfg = unified.UnifiedConfig.avt_7b(vocab_size=tok.vocab_size)

    t0 = time.perf_counter()
    frozen = {"llama": imp.import_llama(imp.load_torch(args.llama_ckpt),
                                        cfg.llama, device=dev)}
    if args.branch == "visual":
        frozen["clip"] = imp.import_clip(imp.load_torch(args.clip_ckpt),
                                         cfg.clip, dtype=torch.bfloat16,
                                         device=dev)
        frozen["beats"] = None
    else:
        sd, bcfg = imp.load_torch(args.beats_ckpt)
        frozen["beats"] = imp.import_beats(
            sd, imp.beats_config_from_ckpt(bcfg), dtype=torch.bfloat16,
            device=dev)
        frozen["clip"] = None
    frozen["llama"], _ = place_llama(mesh, frozen["llama"], False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    if process_rank() == 0:
        print(f"[pretrain] frozen trees ready in "
              f"{time.perf_counter() - t0:.2f} s (checkpoint read + import)",
              flush=True)

    trainable = unified.init_trainable(
        torch.Generator(device=dev).manual_seed(args.seed), cfg,
        with_adapters=False, device=dev)
    ds = PretrainDataset.from_jsons(
        tok.as_tokenize(), image_json=args.image_json,
        video_json=args.video_json, audio_json=args.audio_json,
        image_size=cfg.clip.image_size)

    per_step = args.global_batch
    total_steps = max(len(ds) // per_step, 1) * args.epochs
    tcfg = TrainConfig(learning_rate=args.learning_rate,
                       num_epochs=args.epochs,
                       global_batch_size=per_step,
                       output_dir=args.output_dir, seed=args.seed)
    trainer = Trainer(unified.unified_loss(cfg, train_adapters=False,
                                           mesh=mesh),
                      trainable, frozen, tcfg, total_steps, mesh=mesh)
    per_rank = host_local_batch_size(per_step, mesh)
    # the ranks of one model group feed the same slice
    first = data_parallel_index(mesh)[0] * per_rank

    # one image (or video clip, or audio clip) -> the projector's queries
    # (32 at 7B; the JAX driver writes 32)
    nq_v = cfg.vl_projector.num_query_tokens
    nq_a = cfg.al_projector.num_query_tokens

    def batches():
        rng = np.random.default_rng(args.seed)
        t = tok.as_tokenize()
        for _ in range(args.epochs):
            order = rng.permutation(len(ds))
            for i in range(0, len(order) - per_step + 1, per_step):
                # every rank draws the same order and keeps its slice
                items = [ds[int(j)] for j in
                         order[i + first:i + first + per_rank]]
                assembled, videos, audios = [], [], []
                for it in items:
                    inst = t.encode(it["instruction"])
                    out = t.encode(it["output"])
                    ids = np.asarray(inst + out)
                    labels = np.asarray([-100] * len(inst) + out)
                    assembled.append(asm.assemble_sample(
                        ids, labels, t.token_to_id, t.pad_id,
                        n_video_tokens=nq_v if "video" in it else 0,
                        n_audio_tokens=nq_a if "audio" in it else 0))
                    if "video" in it:
                        videos.append(it["video"])
                    if "audio" in it:
                        audios.append(it["audio"])
                batch = asm.pad_batch(assembled, t.pad_id,
                                      pad_to=args.pad_to)
                if videos:
                    batch["video"] = np.stack(videos)
                if audios:
                    batch["audio"] = np.stack(audios)
                yield to_device(batch, dev)

    trainer.train(batches())
    trainer.finalize(stage1=True)
    return trainer, batches


if __name__ == "__main__":
    main()
