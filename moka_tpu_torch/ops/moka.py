"""MokA adapter math as plain batched torch ops (port of ``moka_tpu/ops/moka.py``).

MokA ("Multimodal low-rank Adaptation", arXiv 2506.05191) adds to each frozen
linear projection:

  1. per-modality LoRA-A down projections, applied only to that modality's
     tokens (token-level modality masks),
  2. cross-modal attention in rank space: non-text tokens attend to the
     question tokens' A-projected representations, added residually with a
     scalar weight,
  3. one shared LoRA-B up projection over the combined rank-space stream.

Because the masks are per-token row scalings, ``(x * m) @ A == m * (x @ A)``,
and the "contiguous question span" key selection is a masked softmax, so
the whole thing is a few batched einsums with no data-dependent shapes.

Two flavours share one function: AVT (A outputs pre-scaled by alpha/r,
attention for video and audio, no post-B scaling) and VT (unscaled A,
attention for the image stream, per-modality post-B scales).

LoRA dropout (``lora_dropout``) follows the JAX rule bit for bit given the
same 16-bit random values; the key type is ``core.rng.DropoutKey``.  With
``fused_dropout`` the dropout is fused into the A projection
(``ops.fused_dropout``, TPU kernels 6-7 as CUDA).  With ``flash_rank_attn``
the rank-space attention runs through ``flash_mha`` at one head of
head_dim r in fp32 (``ops.flash_attention``'s rank route, TPU kernels 1-4
as ``kernels/csrc/flash_rank.cu``), without the question window, as JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from moka_tpu_torch.core.device import resolve_device
from moka_tpu_torch.ops import fused_dropout
from moka_tpu_torch.ops.flash_attention import flash_mha


@dataclasses.dataclass(frozen=True)
class MokaSpec:
    """Static description of one MokA adapter family (same fields as the
    JAX ``MokaSpec``).

    num_modalities: per-modality A matrices (index 0 is text).
    rank: LoRA rank r.
    attn_modalities: streams that run rank-space cross-attention against
      the question tokens (AVT: (1, 2); VT: (1,)).
    attn_weight: weight of the attention residual.
    pre_scale: scalar on every A output before attention (AVT alpha/r).
    post_scales: per-modality scalars on B's output rows (VT), or None.
    dropout_rate: LoRA dropout on the A input (training only).
    bf16_dots: round the adapter matmul inputs to bf16 (fp32 accumulate).
    flash_rank_attn: the rank attention through ``flash_mha`` (the rank
      kernels on the card); the question window does not apply.
    fused_dropout: LoRA dropout fused into the A projection
      (``ops.fused_dropout``).
    dropout_shared_masks: one dropout key per input group of projections
      instead of one per projection (``models.llama._PROJ_GROUP``).
    max_question_tokens: static key window around the question span.
    """

    num_modalities: int
    rank: int
    attn_modalities: tuple[int, ...]
    attn_weight: float
    pre_scale: float = 1.0
    post_scales: tuple[float, ...] | None = None
    dropout_rate: float = 0.0
    bf16_dots: bool = False
    flash_rank_attn: bool = False
    max_question_tokens: int | None = None
    fused_dropout: bool = False
    dropout_shared_masks: bool = False

    def with_bf16_dots(self) -> "MokaSpec":
        return dataclasses.replace(self, bf16_dots=True)

    def with_fused_dropout(self) -> "MokaSpec":
        return dataclasses.replace(self, fused_dropout=True)

    def with_shared_dropout_masks(self) -> "MokaSpec":
        return dataclasses.replace(self, dropout_shared_masks=True)

    def with_question_window(self, kq: int) -> "MokaSpec":
        """Bound the rank-attention keys to a static window of ``kq``
        positions starting at the (contiguous) question span; keys outside
        the span are masked either way, so the math is unchanged."""
        return dataclasses.replace(self, max_question_tokens=kq)

    def with_flash_rank_attn(self) -> "MokaSpec":
        return dataclasses.replace(self, flash_rank_attn=True)

    @staticmethod
    def avt(rank: int = 4, lora_alpha: float = 16.0, blc_weight: float = 1.0,
            dropout_rate: float = 0.05) -> "MokaSpec":
        """Tri-modal (text/video/audio) flavour."""
        return MokaSpec(num_modalities=3, rank=rank, attn_modalities=(1, 2),
                        attn_weight=blc_weight, pre_scale=lora_alpha / rank,
                        post_scales=None, dropout_rate=dropout_rate)

    @staticmethod
    def vt(rank: int = 4, lora_alpha: float = 16.0, attn_weight: float = 0.05,
           dropout_rate: float = 0.05, use_rslora: bool = False) -> "MokaSpec":
        """Bi-modal (text/image) flavour."""
        scale = lora_alpha / math.sqrt(rank) if use_rslora else lora_alpha / rank
        return MokaSpec(num_modalities=2, rank=rank, attn_modalities=(1,),
                        attn_weight=attn_weight, pre_scale=1.0,
                        post_scales=(scale, scale), dropout_rate=dropout_rate)


def init_moka_params(generator: torch.Generator, d_in: int, d_out: int,
                     spec: MokaSpec, *, device=None,
                     dtype=torch.float32) -> dict:
    """Kaiming-uniform A (bound 1/sqrt(d_in)), zero B."""
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(d_in)
    a = torch.rand((spec.num_modalities, d_in, spec.rank), generator=generator,
                   device=dev, dtype=torch.float32) * (2 * bound) - bound
    b = torch.zeros((spec.rank, d_out), device=dev, dtype=dtype)
    return {"a": a.to(dtype), "b": b}


def rank_space_cross_attention(q: torch.Tensor, keys: torch.Tensor,
                               question_mask: torch.Tensor,
                               dk: float) -> torch.Tensor:
    """softmax(q @ keys^T / sqrt(dk)) @ keys, keys masked to the question.

    q, keys: (b, L, r) fp32 (keys may be a (b, kq, r) window);
    question_mask: (b, kq) 0/1.  Rows of samples with no question token get
    zero attention."""
    scores = torch.einsum("blr,bkr->blk", q.float(), keys.float())
    scores = scores / math.sqrt(dk)
    # a Python scalar, not a new device tensor: that would be a blocking
    # host-to-device copy on every call
    scores = torch.where(question_mask[:, None, :] > 0, scores,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    has_q = question_mask.sum(dim=-1) > 0
    probs = torch.where(has_q[:, None, None], probs, probs.new_zeros(()))
    return torch.einsum("blk,bkr->blr", probs.to(keys.dtype), keys)


def flash_rank_space_cross_attention(q: torch.Tensor, keys: torch.Tensor,
                                     question_mask: torch.Tensor, dk: float,
                                     residuals: dict | None = None
                                     ) -> torch.Tensor:
    """``rank_space_cross_attention`` through ``flash_mha``: one head of
    head_dim r, causal off, the question mask as the key mask and the
    default scale 1/sqrt(head_dim) = 1/sqrt(dk).  A sample with no question
    token has all-zero keys, so its rows come out zero and send nothing
    back, as the plain function's guard makes them.  ``keys`` is both k
    and v: autograd sums the two gradients into it.  ``residuals``:
    ``flash_mha``'s, for a remat policy that keeps them."""
    if q.shape[-1] != dk:
        raise ValueError(f"rank {q.shape[-1]} != dk {dk}")
    kv = keys[:, :, None]
    out = flash_mha(q[:, :, None], kv, kv, question_mask, causal=False,
                    residuals=residuals)
    return out[:, :, 0]


def question_window(keys: torch.Tensor, question_mask: torch.Tensor,
                    kq: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather a static (b, kq) window starting at the first question token
    (clamped in bounds; rows without a question get [0, kq) and an all-zero
    mask)."""
    b, L, r = keys.shape
    if kq >= L:
        return keys, question_mask
    start = (question_mask > 0).to(torch.int32).argmax(dim=-1)
    start = torch.clamp(start, max=L - kq)
    idx = start[:, None] + torch.arange(kq, device=keys.device)[None]
    keys_w = torch.gather(keys, 1, idx[..., None].expand(b, kq, r))
    mask_w = torch.gather(question_mask, 1, idx)
    return keys_w, mask_w


def _dot_operand(t: torch.Tensor, spec: MokaSpec) -> torch.Tensor:
    """fp32 matmul operand; with ``bf16_dots`` first rounded to bf16 (the
    product of two bf16 values is exact in fp32, so an fp32 matmul of the
    rounded operands is the bf16-in / fp32-accumulate dot)."""
    if spec.bf16_dots:
        t = t.to(torch.bfloat16)
    return t.float()


def moka_delta(x: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor,
               modality_masks: torch.Tensor, question_mask: torch.Tensor,
               spec: MokaSpec, *, dropout_rng=None,
               flash_residuals: dict | None = None,
               key_question: torch.Tensor | None = None,
               gather_keys=None, sum_a=None) -> torch.Tensor:
    """The MokA low-rank delta for one linear layer.

    x: (b, L, d_in); lora_a: (M, d_in, r); lora_b: (r, d_out);
    modality_masks: (M, b, L) 0/1 (disjoint); question_mask: (b, L) 0/1.
    dropout_rng: a key (``core.rng.DropoutKey``); with a rate > 0, LoRA
      dropout on the A input (training), fused into the A product with
      ``spec.fused_dropout``.
    flash_residuals: with ``spec.flash_rank_attn``, where each modality's
      rank attention keeps its flash residuals (one dict a modality, under
      its index) for a remat policy that keeps them (``models.llama``).
    key_question, gather_keys: context parallelism (x is one shard of the
      sequence): the question keys of every shard are gathered with
      ``gather_keys`` and masked by ``key_question``, the (b, L_total)
      question mask of the whole sequence.
    sum_a: tensor parallelism, a row-parallel projection (x holds this
      rank's columns of the input and lora_a its rows, the dropout key
      their columns): the partial fp32 A products are summed over the
      model group with ``sum_a`` before anything else reads them (the
      rank attention is not linear in them); the rest runs whole on every
      rank.
    Returns the (b, L, d_out) delta in x's dtype (bf16 with
    ``spec.bf16_dots``, as JAX)."""
    m, _, r = lora_a.shape
    if m != spec.num_modalities or r != spec.rank:
        raise ValueError(f"adapter shape {tuple(lora_a.shape)} does not "
                         f"match {spec}")
    drop = dropout_rng is not None and spec.dropout_rate > 0.0
    if drop and spec.fused_dropout:
        # dropout fused into the A product: with bf16_dots x and A reach
        # it in bf16, as in JAX
        x_a, a_a = x, lora_a
        if spec.bf16_dots:
            x_a, a_a = x.to(torch.bfloat16), lora_a.to(torch.bfloat16)
        a_all = fused_dropout.dropout_a_proj(x_a, a_a, dropout_rng,
                                             spec.dropout_rate)
    else:
        x_d = x
        if drop:
            if spec.bf16_dots:  # JAX drops out the bf16-rounded x
                x_d = x.to(torch.bfloat16)
            x_d = lora_dropout(x_d, dropout_rng, spec.dropout_rate)
        a_all = torch.einsum("bld,mdr->mblr", _dot_operand(x_d, spec),
                             _dot_operand(lora_a, spec))
    if sum_a is not None:
        a_all = sum_a(a_all)
    masks = modality_masks.float()
    qmask = question_mask.float()
    a_all = a_all * masks[..., None] * spec.pre_scale

    keys = a_all[0] * qmask[..., None]  # (b, L, r)
    q_mask = qmask
    if gather_keys is not None:
        keys = gather_keys(keys)
        q_mask = key_question.float()
    if spec.flash_rank_attn:
        q_mask = q_mask.to(torch.int32)  # the key mask, once
    elif spec.max_question_tokens is not None:
        keys, q_mask = question_window(keys, q_mask,
                                       spec.max_question_tokens)

    buffer = a_all.sum(dim=0)
    for i in spec.attn_modalities:
        if spec.flash_rank_attn:
            attn = flash_rank_space_cross_attention(
                a_all[i], keys, q_mask, dk=spec.rank,
                residuals=None if flash_residuals is None else
                flash_residuals.setdefault(i, {}))
        else:
            attn = rank_space_cross_attention(a_all[i], keys, q_mask,
                                              dk=spec.rank)
        buffer = buffer + masks[i][..., None] * (spec.attn_weight * attn)

    delta = torch.einsum("blr,rd->bld", _dot_operand(buffer, spec),
                         _dot_operand(lora_b, spec))
    if spec.post_scales is not None:  # disjoint masks: exact either way
        token_scale = sum(masks[i] * ps
                          for i, ps in enumerate(spec.post_scales))
        delta = delta * token_scale[..., None]
    # bf16 dots: JAX casts x itself to bf16, so its delta comes out bf16
    return delta.to(torch.bfloat16 if spec.bf16_dots else x.dtype)


def lora_dropout(x: torch.Tensor, rng, rate: float) -> torch.Tensor:
    """LoRA dropout on the adapter input, the JAX rule exactly: with 16-bit
    values ``bits`` from ``rng.bits``, keep where ``bits < round(keep *
    2^16)`` (capped at 65535) and scale kept values by ``1/keep`` in x's
    dtype."""
    keep = 1.0 - rate
    thresh = min(65535, int(round(keep * 65536.0)))
    bits = rng.bits(x.shape, x.device)
    return torch.where(bits < thresh,
                       x * torch.tensor(1.0 / keep, dtype=x.dtype),
                       x.new_zeros(()))


def lora_delta(x: torch.Tensor, lora_a0: torch.Tensor, lora_b: torch.Tensor,
               scale: float, sum_a=None) -> torch.Tensor:
    """Plain text-adapter LoRA path ``B(A0(x) * scale)`` in fp32 (the
    single-token decode path and the masks-None fallback); ``sum_a`` as
    ``moka_delta``'s."""
    a = torch.einsum("...d,dr->...r", x.float(), lora_a0.float())
    if sum_a is not None:
        a = sum_a(a)
    delta = torch.einsum("...r,rd->...d", a * scale, lora_b.float())
    return delta.to(x.dtype)


def decode_scale(spec: MokaSpec) -> float:
    """The total text-path scale used at single-token decode steps."""
    post = 1.0 if spec.post_scales is None else spec.post_scales[0]
    return spec.pre_scale * post


def moka_linear(x: torch.Tensor, w: torch.Tensor, lora_a: torch.Tensor,
                lora_b: torch.Tensor, modality_masks: torch.Tensor | None,
                question_mask: torch.Tensor | None, spec: MokaSpec, *,
                bias: torch.Tensor | None = None,
                dropout_rng=None) -> torch.Tensor:
    """Frozen base matmul (``w`` stored (d_in, d_out)) + MokA delta; with
    masks None only the text adapter applies."""
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    if modality_masks is None:
        return y + lora_delta(x, lora_a[0], lora_b, decode_scale(spec))
    return y + moka_delta(x, lora_a, lora_b, modality_masks, question_mask,
                          spec, dropout_rng=dropout_rng)
