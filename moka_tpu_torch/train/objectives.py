"""Loss functions binding the model to the generic train step (port of
``moka_tpu/train/objectives.py``).

Under a mesh each rank's loss is its share of the global loss over its
data group (``parallel.mesh.data_parallel_group``: the data x fsdp ranks
of its model coordinate).  The ranks of one model group pass the same
samples and compute the same loss; their adapter gradients are whole or
parts by ``parallel.tensor.grad_is_part``, and ``train.step`` sums the
parts over the model group."""

from __future__ import annotations

import torch

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import llama
from moka_tpu_torch.ops.moka import MokaSpec
from moka_tpu_torch.parallel import comm
from moka_tpu_torch.parallel import tensor as tp
from moka_tpu_torch.parallel.mesh import AXIS_MODEL, axis_size, \
    data_parallel_group, data_parallel_index
from moka_tpu_torch.parallel.stream import fetch
from moka_tpu_torch.train.optim import tree_leaves, tree_map

IGNORE = -100


def global_counts(labels: torch.Tensor, mesh) -> torch.Tensor:
    """(the supervised targets, ``labels[:, 1:]`` not ignored; the labels
    not ignored, JAX's ``supervised_tokens``) of the global batch: this
    rank's, summed over its data group without a gradient."""
    counts = torch.stack([(labels[:, 1:] != IGNORE).sum(),
                          (labels != IGNORE).sum()])
    return comm.all_reduce_sum(counts, data_parallel_group(mesh))


def rank_share(loss: torch.Tensor, labels: torch.Tensor, count) -> torch.Tensor:
    """This rank's part of the global loss: its mean CE times its share of
    the global count of targets (its sum of nll over that count, as JAX's
    CE over the whole batch divides by the whole count).  Summed over the
    data x fsdp group (``make_train_step(mesh=...)``), the parts are the
    global loss and their gradients the global gradient."""
    local = torch.clamp((labels[:, 1:] != IGNORE).sum(), min=1)
    return loss * (local / torch.clamp(count, min=1)).to(loss.dtype)


def check_model_split(base: dict, cfg: LlamaConfig, mesh) -> None:
    """Raise unless the base is split over the mesh's model axis exactly
    when that axis is above 1: the step sums the gradient parts over it
    (``train.step``), and a base split otherwise would train wrong."""
    split = tp.model_split(base["layers"], cfg)
    m = axis_size(mesh, AXIS_MODEL)
    if (split.size if split is not None else 1) != m:
        raise ValueError(f"the base is split over "
                         f"{split.size if split is not None else 1} model "
                         f"ranks and the mesh's model axis is {m}: place it "
                         f"with parallel.sharding.shard_params(mesh, ...)")


def data_rows(rng, mesh, batch_size: int):
    """A ``DropoutKey`` for this rank's samples of the global batch (the
    masks one process would draw for them); ``rng`` itself without a mesh
    or a key of another kind."""
    index, size = data_parallel_index(mesh)
    if size == 1 or not hasattr(rng, "rows"):
        return rng
    return rng.rows(0, index * batch_size, size * batch_size)


def decoder_loss(base: dict, cfg: LlamaConfig, labels: torch.Tensor, mesh,
                 rng, fwd: dict, dropout: bool, fused_loss: bool,
                 a8: bool | str = False, ce_chunk: int = 128,
                 pallas_ce: bool = False, ce_rows: bool = False):
    """``llama.forward(base, cfg, **fwd)`` and the shift-by-one CE against
    ``labels`` (the chunked lm_head + CE with ``fused_loss``), with the
    dropout key when ``dropout``; under ``mesh``, the rank's share of the
    global loss and the global count (``rank_share``, ``global_counts``).
    Returns (loss, {"supervised_tokens"})."""
    check_model_split(base, cfg, mesh)
    key = data_rows(rng, mesh, labels.shape[0]) if dropout else None
    out, _ = llama.forward(base, cfg, dropout_rng=key,
                           logits=not fused_loss, **fwd)
    if fused_loss:
        loss = llama.chunked_cross_entropy(
            out, fetch(base["lm_head"], out.device), labels, chunk=ce_chunk,
            a8=a8, pallas_ce=pallas_ce, rows_layout=ce_rows)
    else:
        loss = llama.cross_entropy_loss(out, labels)
    if mesh is None:
        return loss, {"supervised_tokens": (labels != IGNORE).sum()}
    count, ntok = global_counts(labels, mesh)
    return rank_share(loss, labels, count), {"supervised_tokens": ntok}


def _seq_shard(batch: dict, idx: int, n: int) -> tuple[dict, torch.Tensor]:
    """This rank's shard of every sequence-long field, and its targets: the
    labels shifted by one over the WHOLE sequence before the split (the
    shift crosses shard boundaries), the last position ignored."""
    labels = batch["labels"]
    b, L = labels.shape
    if L % n:
        raise ValueError(f"sequence length {L} does not split over "
                         f"{n} ranks")
    Ls = L // n
    targets = torch.cat([labels[:, 1:], labels.new_full((b, 1), IGNORE)],
                        dim=1)
    dims = {"tokens": 1, "inputs_embeds": 1, "attn_mask": 1,
            "positions": 1, "question_mask": 1, "modality_masks": 2}
    out = {k: (v.narrow(dims[k], idx * Ls, Ls) if k in dims else v)
           for k, v in batch.items() if k != "labels"}
    if "positions" not in batch:
        out["positions"] = (idx * Ls + torch.arange(
            Ls, device=labels.device)).expand(b, Ls)
    return out, targets.narrow(1, idx * Ls, Ls)


def make_llama_moka_loss(cfg: LlamaConfig, spec: MokaSpec,
                         remat: bool = True, use_flash: bool = False,
                         fused_loss: bool = False,
                         remat_policy: str | None = None,
                         use_fused_moka: bool = False,
                         context_parallel=None,
                         ce_chunk: int = 128,
                         a8_dots: bool | str = False,
                         pallas_ce: bool = False,
                         host_stream: dict | None = None,
                         ce_rows: bool = False,
                         save_q8: bool | tuple = False,
                         mesh=None):
    """Adapter-only CE loss on a (possibly multimodal-embedded) batch.

    Batch keys: ``tokens`` (b, L) or ``inputs_embeds`` (b, L, d); ``labels``
    (b, L) with -100 ignored; optional ``modality_masks`` (M, b, L),
    ``question_mask`` (b, L), ``attn_mask`` (b, L), ``positions`` (b, L).
    use_flash: the flash attention kernels (forward and backward);
    fused_loss: the chunked lm_head + CE (``ce_chunk`` positions, or rows
    with ``ce_rows``); remat: recompute each layer in the backward, keeping
    what ``remat_policy`` keeps (``llama.REMAT_POLICIES``); use_fused_moka:
    the fused MokA kernel, dropout applied outside it.  On a quantized
    base: ``a8_dots`` the W4A8/W8A8 products (base and head), ``save_q8``
    the int8/fp8 save set, ``pallas_ce`` the fused lm_head + CE kernels on
    an int8 head (``llama.forward``, ``llama.chunked_cross_entropy``).

    Parallelism:
      host_stream: ``parallel.sharding.stream_shardings(mesh, frozen)``
        for a base in pinned host memory: the layers stream per use
        (``llama.forward``) and the lm_head is copied once a call.
      mesh: the training mesh; the batch is this rank's samples (the
        same on every rank of a model group), the loss this rank's share
        of the global loss (``rank_share``: the CE over the global count
        of targets, as JAX's over the whole batch) and
        ``supervised_tokens`` the global count.  ``make_train_step(mesh=
        ...)`` sums the shares and the gradients.  Dropout draws the
        masks of this rank's rows of the global batch (and, in a
        row-parallel projection, of its columns).  With a model axis
        above 1 the base must be split over it (``shard_params``).
      context_parallel: (mesh, axis): every rank passes the whole batch;
        each runs its shard of the sequence (``llama.forward``'s ring) and
        the loss comes back whole on every rank, with the whole gradient
        (the trainables' gradients are summed over the sequence group in
        the backward).
    """
    if context_parallel is not None and mesh is not None:
        raise ValueError("context_parallel and a data-parallel mesh do not "
                         "combine")

    def fwd_args(trainable, batch, **cp):
        masks = None
        if "modality_masks" in batch:
            masks = llama.MaskBundle(batch["modality_masks"],
                                     batch["question_mask"])
        return dict(adapters=trainable["adapters"], spec=spec,
                    tokens=batch.get("tokens"),
                    inputs_embeds=batch.get("inputs_embeds"), masks=masks,
                    attn_mask=batch.get("attn_mask"),
                    positions=batch.get("positions"), remat=remat,
                    remat_policy=remat_policy, use_flash=use_flash,
                    use_fused_moka=use_fused_moka, a8_dots=a8_dots,
                    save_q8=save_q8, host_stream=host_stream, **cp)

    def loss_fn(trainable, frozen, batch, rng):
        if context_parallel is not None:
            return _cp_loss(trainable, frozen, batch, rng)
        return decoder_loss(frozen, cfg, batch["labels"], mesh, rng,
                            fwd_args(trainable, batch),
                            dropout=spec.dropout_rate > 0,
                            fused_loss=fused_loss, a8=a8_dots,
                            ce_chunk=ce_chunk, pallas_ce=pallas_ce,
                            ce_rows=ce_rows)

    def _cp_loss(trainable, frozen, batch, rng):
        cp_mesh, cp_axis = context_parallel
        group = cp_mesh.get_group(cp_axis)
        local, targets = _seq_shard(batch, cp_mesh.get_local_rank(cp_axis),
                                    comm.group_size(group))
        leaves = tree_leaves(trainable)
        it = iter(comm.sum_grads(leaves, group))
        trainable = tree_map(lambda _: next(it), trainable)
        out, _ = llama.forward(
            frozen, cfg, dropout_rng=rng if spec.dropout_rate > 0 else None,
            logits=not fused_loss,
            **fwd_args(trainable, local, context_parallel=context_parallel))
        count = torch.clamp((batch["labels"][:, 1:] != IGNORE).sum(), min=1)
        if fused_loss:
            nll = llama.chunked_cross_entropy(
                out, fetch(frozen["lm_head"], out.device), targets,
                chunk=ce_chunk, a8=a8_dots, pallas_ce=pallas_ce,
                shifted=True, count=count)
        else:
            nll = llama.cross_entropy_loss(out, targets, shifted=True,
                                           count=count)
        loss = comm.sum_value(nll, group)
        return loss, {"supervised_tokens": (batch["labels"] != IGNORE).sum()}

    return loss_fn
