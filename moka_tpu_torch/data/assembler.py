"""Multimodal sequence assembly: splice encoder features into the token
stream and build the four modality masks (the port's own copy of
``moka_tpu/data/assembler.py``).

Semantics, as the reference's ``prepare_multimodal_inputs``:

  * marker tokens ``<image>/<video>/<audio>/<question_start>/<question_end>``
    are removed from the stream; ``<video_start>``-style tokens stay as
    ordinary text;
  * text segments: text_mask=1; the segment ending at ``<question_end>``
    also gets question_mask=1;
  * feature spans: video/image -> video_mask=1, audio -> audio_mask=1,
    labels=-100;
  * LEFT padding with pad ids, masks/attention 0, labels -100; positions =
    cumsum(attn)-1 clamped at 0.

The walk runs on the host in numpy and emits fixed-shape integer arrays
(ids with pad placeholders at feature positions and per-modality scatter
indices); ``splice_features`` writes the projector outputs into the
embedding stream on the device, out of place, so that the projectors
receive their gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

IGNORE = -100


class QuestionWindowOverflow(ValueError):
    """A question span exceeds the configured rank-attention window."""


SPECIAL_TOKENS = ["<image>", "<image_start>", "<image_end>",
                  "<video>", "<video_start>", "<video_end>",
                  "<audio>", "<audio_start>", "<audio_end>",
                  "<question_start>", "<question_end>"]
MARKER_KEYS = ["<image>", "<video>", "<audio>",
               "<question_start>", "<question_end>"]


@dataclasses.dataclass
class AssembledSample:
    """Fixed-layout single sample (unpadded)."""
    ids: np.ndarray            # (L,) token ids; pad_id at feature positions
    labels: np.ndarray         # (L,)
    text_mask: np.ndarray      # (L,)
    video_mask: np.ndarray
    audio_mask: np.ndarray
    question_mask: np.ndarray
    video_pos: np.ndarray      # (n_video,) positions of video feature tokens
    audio_pos: np.ndarray      # (n_audio,)


def _check_question_extent(qm: np.ndarray, kq: int,
                           on_overflow: str = "raise") -> bool:
    """Guard a question span against a kq-token rank-attention window
    (``MokaSpec.with_question_window``).  The correctness condition is
    the span EXTENT — last flagged position - first + 1 — since the windowed
    attention gathers kq contiguous positions anchored at the first one
    (interior unflagged positions stay masked, so extent <= kq is exact).

    ``on_overflow``:
      * ``"raise"`` (eval/parity paths): fail fast — a silently truncated
        key set would corrupt checkpoint-parity evals.
      * ``"disable"`` (training): log a warning and return True; the caller
        zeroes the sample's question mask, which the rank attention's
        no-question guard (``ops.moka.moka_delta``) turns into an EXACT
        zero cross-attention term for that sample — the outlier trains
        through the per-modality LoRA paths only, and one long question at
        step 90k cannot abort the run.
    Returns True when the span overflows (and on_overflow permits it).
    """
    idx = np.nonzero(qm > 0)[0]
    if len(idx) == 0:
        return False
    extent = int(idx[-1] - idx[0] + 1)
    if extent <= kq:
        return False
    if on_overflow == "disable":
        import logging
        logging.getLogger(__name__).warning(
            "question span extent %d exceeds the rank-attention window %d; "
            "disabling the cross-attention term for this sample "
            "(question mask zeroed)", extent, kq)
        return True
    raise QuestionWindowOverflow(
        f"question span extent of {extent} tokens exceeds the "
        f"configured rank-attention window ({kq}); raise "
        f"--question-window or shorten the prompt")


def assemble_sample(input_ids: np.ndarray, labels: np.ndarray,
                    token_to_id: dict, pad_id: int,
                    n_video_tokens: int = 0,
                    n_audio_tokens: int = 0,
                    max_question_tokens: int | None = None,
                    question_overflow: str = "raise") -> AssembledSample:
    """Host-side walk mirroring ``prepare_multimodal_inputs`` for one sample.

    ``n_video_tokens``/``n_audio_tokens`` are the projector output lengths
    (t*32) spliced at each ``<video>``/``<image>`` / ``<audio>`` marker.
    ``max_question_tokens``: when the model runs with a rank-attention
    question window (``MokaSpec.with_question_window``), pass the same bound
    here — a question span exceeding it would be silently truncated by the
    attention.  ``question_overflow``: ``"raise"`` fails fast (eval/parity);
    ``"disable"`` (training) zeroes the sample's question mask instead —
    see ``_check_question_extent``."""
    id_to_key = {token_to_id[k]: k for k in MARKER_KEYS if k in token_to_id}
    out_ids, out_labels = [], []
    tm, vm, am, qm = [], [], [], []
    video_pos, audio_pos = [], []

    def text_seg(seg_ids, seg_labels, is_question):
        out_ids.extend(int(t) for t in seg_ids)
        out_labels.extend(int(l) for l in seg_labels)
        n = len(seg_ids)
        tm.extend([1] * n)
        vm.extend([0] * n)
        am.extend([0] * n)
        qm.extend([1 if is_question else 0] * n)

    def feature_seg(n, kind):
        start = len(out_ids)
        out_ids.extend([pad_id] * n)
        out_labels.extend([IGNORE] * n)
        tm.extend([0] * n)
        vm.extend([1 if kind == "video" else 0] * n)
        am.extend([1 if kind == "audio" else 0] * n)
        qm.extend([0] * n)
        pos = list(range(start, start + n))
        (video_pos if kind == "video" else audio_pos).extend(pos)

    pre = 0
    marker_positions = [i for i, t in enumerate(input_ids)
                        if int(t) in id_to_key]
    for idx in marker_positions:
        key = id_to_key[int(input_ids[idx])]
        text_seg(input_ids[pre:idx], labels[pre:idx],
                 is_question=(key == "<question_end>"))
        if key in ("<video>", "<image>"):
            feature_seg(n_video_tokens, "video")
        elif key == "<audio>":
            feature_seg(n_audio_tokens, "audio")
        # <question_start>/<question_end>: marker dropped, nothing spliced
        pre = idx + 1
    text_seg(input_ids[pre:], labels[pre:], is_question=False)

    if max_question_tokens is not None:
        if _check_question_extent(np.asarray(qm), max_question_tokens,
                                  question_overflow):
            qm = [0] * len(qm)

    return AssembledSample(
        ids=np.asarray(out_ids, np.int32),
        labels=np.asarray(out_labels, np.int32),
        text_mask=np.asarray(tm, np.float32),
        video_mask=np.asarray(vm, np.float32),
        audio_mask=np.asarray(am, np.float32),
        question_mask=np.asarray(qm, np.float32),
        video_pos=np.asarray(video_pos, np.int32),
        audio_pos=np.asarray(audio_pos, np.int32),
    )


def pad_batch(samples: list[AssembledSample], pad_id: int,
              pad_to: int | None = None, left_pad: bool = True) -> dict:
    """LEFT-pad to the batch max (or a static bucket length ``pad_to`` so jit
    never retraces).  Returns the batch dict consumed by the models."""
    max_len = max(len(s.ids) for s in samples)
    L = pad_to if pad_to is not None else max_len
    if L < max_len:
        raise ValueError(f"pad_to={L} < longest sample {max_len}")
    b = len(samples)
    ids = np.full((b, L), pad_id, np.int32)
    labels = np.full((b, L), IGNORE, np.int32)
    attn = np.zeros((b, L), np.int32)
    masks = np.zeros((4, b, L), np.float32)  # text, video, audio, question
    nv = len(samples[0].video_pos)
    na = len(samples[0].audio_pos)
    video_pos = np.zeros((b, nv), np.int32)
    audio_pos = np.zeros((b, na), np.int32)
    for i, s in enumerate(samples):
        n = len(s.ids)
        off = L - n if left_pad else 0
        sl = slice(off, off + n)
        ids[i, sl] = s.ids
        labels[i, sl] = s.labels
        attn[i, sl] = 1
        masks[0, i, sl] = s.text_mask
        masks[1, i, sl] = s.video_mask
        masks[2, i, sl] = s.audio_mask
        masks[3, i, sl] = s.question_mask
        if len(s.video_pos) != nv or len(s.audio_pos) != na:
            raise ValueError("feature token counts must be static per batch")
        video_pos[i] = s.video_pos + off
        audio_pos[i] = s.audio_pos + off
    positions = np.maximum(np.cumsum(attn, axis=-1) - 1, 0).astype(np.int32)
    return {
        "ids": ids, "labels": labels, "attn_mask": attn,
        "positions": positions,
        "modality_masks": masks[:3], "question_mask": masks[3],
        "video_pos": video_pos, "audio_pos": audio_pos,
    }


def splice_features(embeds: torch.Tensor,
                    video_features: torch.Tensor | None = None,
                    video_pos: torch.Tensor | None = None,
                    audio_features: torch.Tensor | None = None,
                    audio_pos: torch.Tensor | None = None) -> torch.Tensor:
    """The projector outputs written into the embedding stream: embeds
    (b, L, d); *_features (b, n, d); *_pos (b, n) integer positions.  An
    out-of-place ``index_put``, differentiable in ``embeds`` and in the
    features."""
    rows = torch.arange(embeds.shape[0], device=embeds.device)[:, None]
    for feats, pos in ((video_features, video_pos),
                       (audio_features, audio_pos)):
        if feats is not None and pos is not None and pos.shape[1] > 0:
            embeds = embeds.index_put((rows, pos.long()),
                                      feats.to(embeds.dtype))
    return embeds
