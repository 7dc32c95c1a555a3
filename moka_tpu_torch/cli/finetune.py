"""Stage-2 fine-tune driver, MUSIC-AVQA / AVE (port of
``moka_tpu/cli/finetune.py``).

One flag namespace; recipe defaults mirror the reference
(``ft_musicavqa.sh``): r=4x3 adapters alpha 16 dropout 0.05 blc_weight 1
on all 7 projections, lr 1e-4 cosine, bf16 frozen base, gradient
checkpointing, global batch 32, 3 epochs.

    python -m moka_tpu_torch.cli.finetune --llama-ckpt DIR --clip-ckpt DIR \\
        --beats-ckpt FILE.pt --tokenizer-json tokenizer.json \\
        --avqa-annotation avqa.json --output-dir runs/ft

On the card unless ``--device cpu``.  Several ranks run under torchrun,
one GPU a rank over NCCL (gloo on the CPU):

    torchrun --nproc_per_node 8 -m moka_tpu_torch.cli.finetune ... \
        --mesh fsdp

``--mesh``: ``fsdp`` = (1, world, 1), ``data`` = (world, 1, 1), or
explicit ``d,f,m`` sizes whose product is the world size; the frozen LLaMA
base is sharded by the rule table (``parallel.sharding``), each rank feeds
its slice of every global batch (the ranks of one model group the same
slice), and the step sums the gradients over data x fsdp.  A ``model``
size above 1 runs the decoder tensor-parallel (``parallel.tensor``: the
projections split over the model group, the gradient parts summed over
it), e.g. ``torchrun --nproc_per_node 2 -m moka_tpu_torch.cli.finetune
... --mesh 1,1,2``.
``--host-offload`` keeps the frozen LLaMA base in pinned host memory and
streams it to the card a layer at a time (``llama.forward(host_stream=
...)``).  ``--rng-impl`` is recorded in ``saved_config.json``; the port
has one dropout generator.
"""

from __future__ import annotations

import argparse
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moka-finetune")
    p.add_argument("--llama-ckpt", help="HF LLaMA dir/safetensors")
    p.add_argument("--clip-ckpt", help="HF CLIP vision dir/safetensors")
    p.add_argument("--beats-ckpt", help="BEATs .pt")
    p.add_argument("--tokenizer-json", help="tokenizers-lib tokenizer.json")
    p.add_argument("--vl-pretrain", help="visual projector stage-1 ckpt")
    p.add_argument("--al-pretrain", help="audio projector stage-1 ckpt")
    p.add_argument("--avqa-annotation")
    p.add_argument("--ave-annotation")
    p.add_argument("--ave-data-root")
    p.add_argument("--output-dir", default="runs/finetune")
    p.add_argument("--lora-r", type=int, default=4)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-dropout", type=float, default=0.05)
    p.add_argument("--blc-weight", type=float, default=1.0)
    p.add_argument("--question-window", type=int, default=0,
                   help="static rank-attention key window (tokens): the "
                        "scores shrink (b,L,L)->(b,L,kq); assembly fails "
                        "fast on longer question spans. 0 = full-length "
                        "keys")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--global-batch", type=int, default=32)
    p.add_argument("--pad-to", type=int, default=1024)
    p.add_argument("--save-steps", type=float, default=0,
                   help="absolute steps, or a 0-1 fraction of total steps "
                        "(reference --save_steps 0.1)")
    p.add_argument("--mesh", default="fsdp",
                   help="'fsdp' | 'data' | 'd,f,m' explicit axis sizes "
                        "(their product: the world size)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--quantize-base", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="int8/int4 weight-only frozen base (QLoRA-style); "
                        "bare flag = int8")
    p.add_argument("--quantize-encoders", nargs="?", type=int, const=8,
                   choices=(4, 8), default=0,
                   help="weight-only quantization of the frozen CLIP/BEATs "
                        "towers")
    p.add_argument("--quantize-head", nargs="?", type=int, const=8,
                   default=0, choices=[4, 8], metavar="BITS",
                   help="with --quantize-base: also quantize the frozen "
                        "lm_head (with --a8-dots the chunked CE's head "
                        "product runs int8)")
    p.add_argument("--model-preset",
                   choices=["7b", "13b", "34b", "70b", "tiny"], default="7b",
                   help="LLaMA base size ('tiny' = small random-init model "
                        "for smoke tests)")
    p.add_argument("--loftq-iters", type=int, default=0, metavar="N",
                   help="with --quantize-base: LoftQ adapter init (N rounds "
                        "of quantize-residual SVD, adapters/loftq.py)")
    p.add_argument("--host-offload", action="store_true",
                   help="frozen LLaMA base in pinned host memory, streamed "
                        "to the card a layer at a time")
    p.add_argument("--remat-policy", default="auto",
                   help="per-layer remat policy (models.llama."
                        "REMAT_POLICIES); 'auto' = 'qkvod' for 7b, full "
                        "remat for tiny")
    p.add_argument("--rng-impl", default="rbg",
                   help="the JAX package's dropout PRNG choice: recorded, "
                        "one generator here")
    p.add_argument("--shared-dropout-masks", action="store_true",
                   help="one LoRA-dropout mask per distinct adapter input "
                        "(q/k/v; gate/up) instead of per projection")
    p.add_argument("--a8-dots", nargs="?", const=True, default=False,
                   choices=[True, False, "full"],
                   help="dynamic per-token int8 activations on the "
                        "quantized frozen-base projections (W4A8/W8A8); "
                        "'full' also quantizes the backward cotangent")
    p.add_argument("--save-q8", action="store_true",
                   help="int8-quantize the remat save set "
                        "(quant.q8_roundtrip)")
    p.add_argument("--adapter-fp32", action="store_true",
                   help="true-fp32 adapter products (default: bf16 in, "
                        "fp32 accumulation)")
    p.add_argument("--qformer-question-tokenizer",
                   help="BERT-vocab tokenizer.json: feeds the question text "
                        "to the projectors' text stream")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def init_distributed(device=None) -> None:
    """The process group from torchrun's environment (none in one
    process): ``parallel.mesh.init_distributed``."""
    from moka_tpu_torch.parallel.mesh import init_distributed as init
    init(device)


def mesh_from_flag(flag: str):
    """The ``--mesh`` flag as a ``MeshConfig`` over the world: 'fsdp' is
    (1, world, 1), 'data' (world, 1, 1), else the explicit 'd,f,m' sizes
    (``model`` above 1: tensor parallelism)."""
    from moka_tpu_torch.core.config import MeshConfig
    from moka_tpu_torch.parallel.mesh import world_size
    n = world_size()
    if flag == "fsdp":
        return MeshConfig(1, n, 1)
    if flag == "data":
        return MeshConfig(n, 1, 1)
    return MeshConfig(*(int(x) for x in flag.split(",")))


def make_mesh_from_flag(flag: str):
    """The ``DeviceMesh`` of ``--mesh`` (``parallel.mesh.make_mesh``), or
    None in one process, where the sizes must multiply to 1."""
    from moka_tpu_torch.parallel.mesh import initialized, make_mesh
    cfg = mesh_from_flag(flag)
    if not initialized():
        if cfg.num_devices != 1:
            raise ValueError(f"mesh {cfg} wants {cfg.num_devices} devices, "
                             f"have 1")
        return None
    return make_mesh(cfg)


def place_llama(mesh, tree: dict, host_offload: bool):
    """The frozen LLaMA tree sharded by the rule table, in pinned host
    memory with ``host_offload``; returns (tree, the ``host_stream``
    placements for the loss, or None).  The encoders stay whole on the
    card (replicated by the rules; they cannot be streamed)."""
    from moka_tpu_torch.parallel.sharding import shard_params, \
        stream_shardings
    placed = shard_params(mesh, tree, host_offload=host_offload)
    return placed, (stream_shardings(mesh, tree) if host_offload else None)


def describe_placement(tree: dict) -> str:
    q = tree["layers"]["q"]
    arr = q.get("w_i8", q.get("w_i4")) if isinstance(q, dict) else q
    from moka_tpu_torch.parallel.sharding import shard_info
    info = shard_info(arr)
    spec = info.placement.spec if info is not None else "whole"
    return (f"{arr.device} {arr.dtype} {tuple(arr.shape)} (sharding "
            f"{spec}, quantized={isinstance(q, dict)}, pinned="
            f"{arr.is_pinned() if arr.device.type == 'cpu' else False})")


def resolve_remat(policy: str, preset: str):
    if policy == "auto":
        return None if preset == "tiny" else "qkvod"
    return None if policy in ("none", "full") else policy


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on ``device`` (list fields
    dropped)."""
    import torch
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if not isinstance(v, list)}


def main(argv=None):
    """Train and export; returns the ``Trainer`` (its state, frozen trees
    and step function) and the batch generator, for callers that go on
    from the run."""
    args = build_argparser().parse_args(argv)
    import dataclasses

    import torch

    from moka_tpu_torch.core.config import LlamaConfig, TrainConfig
    from moka_tpu_torch.data.datasets import UnifiedDataset
    from moka_tpu_torch.data.tokenizer import load_tokenizer
    from moka_tpu_torch.models import unified
    from moka_tpu_torch.ops.moka import MokaSpec
    from moka_tpu_torch.parallel.mesh import (data_parallel_index,
                                              host_local_batch_size,
                                              rank_device)
    from moka_tpu_torch.train import import_torch as imp
    from moka_tpu_torch.train.trainer import Trainer, process_rank

    init_distributed(args.device)
    dev = rank_device(args.device)
    mesh = make_mesh_from_flag(args.mesh)

    spec = MokaSpec.avt(rank=args.lora_r, lora_alpha=args.lora_alpha,
                        blc_weight=args.blc_weight,
                        dropout_rate=args.lora_dropout)
    if not args.adapter_fp32:
        spec = spec.with_bf16_dots()
    if args.question_window:
        spec = spec.with_question_window(args.question_window)
    if args.shared_dropout_masks:
        spec = spec.with_shared_dropout_masks()
    remat_policy = resolve_remat(args.remat_policy, args.model_preset)
    tok = load_tokenizer(args.tokenizer_json)
    if args.model_preset == "tiny":
        base = unified.UnifiedConfig.tiny(spec=spec)
        cfg = dataclasses.replace(base, llama=dataclasses.replace(
            base.llama, vocab_size=max(tok.vocab_size,
                                       base.llama.vocab_size)))
    else:
        lcfg = {"7b": LlamaConfig.llama2_7b, "13b": LlamaConfig.llama2_13b,
                "34b": LlamaConfig.llama_34b,
                "70b": LlamaConfig.llama2_70b}[args.model_preset](
            vocab_size=tok.vocab_size)
        cfg = unified.UnifiedConfig.avt(lcfg, spec=spec)

    if args.loftq_iters and not args.quantize_base:
        raise SystemExit("--loftq-iters requires --quantize-base")
    if args.quantize_head and not args.quantize_base:
        raise SystemExit("--quantize-head requires --quantize-base")
    loftq_adapters = None

    def _quantize_llama(bf16_tree):
        """Plain symmetric quantization, or LoftQ (quantize + an adapter
        init correcting the quantization residual) with --loftq-iters."""
        nonlocal loftq_adapters
        from moka_tpu_torch.ops.quant import (quantize_int4, quantize_int8,
                                              quantize_llama_base)
        if args.loftq_iters:
            from moka_tpu_torch.adapters.loftq import \
                loftq_init_moka_adapters
            qtree, loftq_adapters = loftq_init_moka_adapters(
                bf16_tree, cfg.llama, spec, num_bits=args.quantize_base,
                num_iter=args.loftq_iters)
            if args.quantize_head:
                hq = {8: quantize_int8, 4: quantize_int4}[args.quantize_head]
                qtree = dict(qtree)
                qtree["lm_head"] = hq(qtree["lm_head"], axis=-2)
            return qtree
        return quantize_llama_base(bf16_tree, bits=args.quantize_base,
                                   head_bits=args.quantize_head or None)

    # frozen towers from reference checkpoints (random init if absent:
    # the smoke/debug mode)
    t0 = time.perf_counter()
    if args.llama_ckpt:
        if args.quantize_base and not args.loftq_iters:
            from moka_tpu_torch.ops.quant import import_llama_quantized
            llama_params = import_llama_quantized(
                imp.load_torch(args.llama_ckpt), cfg.llama,
                bits=args.quantize_base,
                head_bits=args.quantize_head or None, device=dev)
        else:
            llama_params = imp.import_llama(
                imp.load_torch(args.llama_ckpt), cfg.llama, device=dev)
            if args.quantize_base:
                llama_params = _quantize_llama(llama_params)
        frozen = {
            "llama": llama_params,
            "clip": imp.import_clip(imp.load_torch(args.clip_ckpt),
                                    cfg.clip, dtype=torch.bfloat16,
                                    device=dev),
        }
        beats_sd, beats_cfg = imp.load_torch(args.beats_ckpt)
        frozen["beats"] = imp.import_beats(
            beats_sd, imp.beats_config_from_ckpt(beats_cfg),
            dtype=torch.bfloat16, device=dev)
    else:
        frozen = unified.init_frozen(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev,
            dtype=torch.float32 if args.model_preset == "tiny"
            else torch.bfloat16)
        if args.quantize_base:
            frozen["llama"] = _quantize_llama(frozen["llama"])
    if args.quantize_encoders:
        from moka_tpu_torch.ops.quant import quantize_encoder
        frozen["clip"] = quantize_encoder(frozen["clip"],
                                          bits=args.quantize_encoders)
        frozen["beats"] = quantize_encoder(frozen["beats"],
                                           bits=args.quantize_encoders)
    frozen["llama"], host_stream = place_llama(mesh, frozen["llama"],
                                               args.host_offload)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # the whole base, once sharded/offloaded
    rank = process_rank()
    if rank == 0:
        print(f"base q: {describe_placement(frozen['llama'])}; frozen "
              f"trees ready in {time.perf_counter() - t0:.2f} s (checkpoint "
              f"read + import + quantize + placement)", flush=True)

    trainable = unified.init_trainable(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    if loftq_adapters is not None:
        trainable["adapters"] = loftq_adapters
    for flag, key, kind in ((args.vl_pretrain, "vl_projector", "visual"),
                            (args.al_pretrain, "al_projector", "audio")):
        if flag:
            sd = imp.load_torch(flag)
            # stage-1 artifacts may carry a 'model.' wrapper prefix and the
            # resized embedding rows; both are dropped
            sub = imp.strip_to_submodule(sd, f"{key}.")
            if not sub:
                sd.pop("embed_tokens.weight", None)
                sd.pop("model.embed_tokens.weight", None)
                sub = sd
            trainable[key] = imp.import_projector(
                sub, getattr(cfg, key), kind=kind, device=dev)

    nq_v = cfg.vl_projector.num_query_tokens
    nq_a = cfg.al_projector.num_query_tokens
    n_frames = 2 if args.model_preset == "tiny" else 10
    qf_tok = None
    if args.qformer_question_tokenizer:
        from tokenizers import Tokenizer as _BertTok
        _bt = _BertTok.from_file(args.qformer_question_tokenizer)
        qf_tok = lambda s: _bt.encode(s).ids  # noqa: E731
    ds = UnifiedDataset(tok.as_tokenize(), mode="train",
                        qformer_tokenize=qf_tok,
                        avqa_annotation=args.avqa_annotation,
                        ave_annotation=args.ave_annotation,
                        ave_data_root=args.ave_data_root,
                        video_frame_nums=n_frames,
                        image_size=cfg.clip.image_size,
                        n_video_tokens=n_frames * nq_v,
                        n_audio_tokens=10 * nq_a,  # 10 audio windows always
                        max_question_tokens=args.question_window or None)
    per_step = args.global_batch
    steps_per_epoch = max(len(ds) // per_step, 1)
    total_steps = steps_per_epoch * args.epochs

    tcfg = TrainConfig(learning_rate=args.learning_rate,
                       num_epochs=args.epochs,
                       global_batch_size=args.global_batch,
                       save_every_steps=args.save_steps,
                       output_dir=args.output_dir, seed=args.seed,
                       remat_policy=remat_policy, rng_impl=args.rng_impl)
    big = args.model_preset != "tiny"
    trainer = Trainer(unified.unified_loss(cfg, remat=True,
                                           remat_policy=remat_policy,
                                           use_flash=big, fused_loss=big,
                                           a8_dots=args.a8_dots,
                                           save_q8=args.save_q8, mesh=mesh,
                                           host_stream=host_stream),
                      trainable, frozen, tcfg, total_steps, full_config=tcfg,
                      mesh=mesh)

    def batches():
        # every process draws the SAME global order (same seed) and feeds
        # its data group's slice of each global batch (the ranks of one
        # model group the same one); video decode and fbank run in a
        # thread pool overlapping the device step.  Batches are
        # task-grouped: AVQA and AVE have different audio segment shapes.
        from moka_tpu_torch.data.prefetch import ParallelLoader
        from moka_tpu_torch.train.trainer import host_sharded_order
        index, world = data_parallel_index(mesh)

        def collate(items):
            return to_device(ds.collate(items, pad_to=args.pad_to), dev)

        group_key = [s["task_name"] for s in ds.samples]
        lengths = [len(s["instruction"]) for s in ds.samples]
        loader = ParallelLoader(ds, collate,
                                batch_size=host_local_batch_size(per_step,
                                                                 mesh))
        for epoch in range(args.epochs):
            order = host_sharded_order(lengths, group_key, per_step,
                                       index, world, seed=args.seed + epoch)
            yield from loader.epoch(order)

    trainer.train(batches())
    trainer.finalize()
    return trainer, batches


if __name__ == "__main__":
    main()
