"""Loss functions binding the model to the generic train step (port of
``moka_tpu/train/objectives.py``)."""

from __future__ import annotations

from moka_tpu_torch.core.config import LlamaConfig
from moka_tpu_torch.models import llama
from moka_tpu_torch.ops.moka import MokaSpec

_NOT_PORTED = "{} is not ported yet (ROADMAP.md, {})"


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
                         save_q8: bool | tuple = False):
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
    ``context_parallel`` and ``host_stream`` are not ported yet and
    raise."""
    for flag, value, item in (
            ("context_parallel", context_parallel is not None,
             "module item 4, parallelism"),
            ("host_stream", host_stream is not None,
             "module item 4, parallelism")):
        if value:
            raise NotImplementedError(_NOT_PORTED.format(flag, item))

    def loss_fn(trainable, frozen, batch, rng):
        masks = None
        if "modality_masks" in batch:
            masks = llama.MaskBundle(batch["modality_masks"],
                                     batch["question_mask"])
        out, _ = llama.forward(
            frozen, cfg, adapters=trainable["adapters"], spec=spec,
            tokens=batch.get("tokens"),
            inputs_embeds=batch.get("inputs_embeds"),
            masks=masks, attn_mask=batch.get("attn_mask"),
            positions=batch.get("positions"), remat=remat,
            remat_policy=remat_policy,
            dropout_rng=rng if spec.dropout_rate > 0 else None,
            logits=not fused_loss, use_flash=use_flash,
            use_fused_moka=use_fused_moka, a8_dots=a8_dots,
            save_q8=save_q8)
        if fused_loss:
            loss = llama.chunked_cross_entropy(out, frozen["lm_head"],
                                               batch["labels"],
                                               chunk=ce_chunk, a8=a8_dots,
                                               pallas_ce=pallas_ce,
                                               rows_layout=ce_rows)
        else:
            loss = llama.cross_entropy_loss(out, batch["labels"])
        ntok = (batch["labels"] != -100).sum()
        return loss, {"supervised_tokens": ntok}

    return loss_fn
