"""VisualText SFT sample construction, LLaVA-Instruct-style (port of
``moka_tpu/data/vt_dataset.py``).

Reference: ``VisualText/train/train.py:68-318`` — multi-turn conversations
split into single turns (:88-109), ``<image>`` expanded x32 (:197), image
masks from the placeholder ids which are then zeroed to ``image_token_id=0``
(:206-213), labels = spans between ``[/INST]`` and ``</s>``
(``tokenizer_target``, :116-156), question_mask = non-image AND label==-100
AND after-the-last-image-token (:221-231), right-padded batches with one
shared arange ``position_ids`` (:267-318).

Host-side numpy; tokenizer-agnostic (callers pass token ids with the image
placeholder already repeated)."""

from __future__ import annotations

import numpy as np

IGNORE = -100


def build_vt_sample(input_ids: np.ndarray, labels: np.ndarray,
                    image_placeholder_id: int, pad_id: int,
                    num_image_tokens: int = 32) -> dict:
    """One sample: ids with placeholders already expanded (x32).

    Returns ids (placeholders -> pad; embeddings get overwritten by the
    splice), image_pos, text/image/question masks."""
    ids = np.asarray(input_ids, np.int32).copy()
    labels = np.asarray(labels, np.int32)
    img = ids == image_placeholder_id
    n_img = int(img.sum())
    if n_img % num_image_tokens:
        raise ValueError(f"{n_img} image tokens not a multiple of "
                         f"{num_image_tokens}")
    image_pos = np.nonzero(img)[0].astype(np.int32)
    text_mask = (~img).astype(np.float32)
    image_mask = img.astype(np.float32)

    # question span: non-image, unsupervised, strictly after the last image
    # token (train.py:221-231); no image -> no question span (matches the
    # reference's after-last-image definition degenerating).
    question_mask = np.zeros(len(ids), np.float32)
    if n_img:
        last_img = image_pos[-1]
        question_mask[(np.arange(len(ids)) > last_img)
                      & (labels == IGNORE) & (~img)] = 1.0
    ids[img] = pad_id
    return {"ids": ids, "labels": labels, "image_pos": image_pos,
            "text_mask": text_mask, "image_mask": image_mask,
            "question_mask": question_mask}


def collate_vt(samples: list[dict], pad_id: int,
               pad_to: int | None = None,
               max_question_tokens: int | None = None,
               question_overflow: str = "raise") -> dict:
    """RIGHT-pad (train.py:267-318) with shared arange positions.

    ``max_question_tokens`` mirrors ``MokaSpec.max_question_tokens``: fail
    at collation rather than silently truncate the rank-attention key set
    (the VT span is the non-image unsupervised tail after the last image
    token, which can be long for verbose prompts).  ``question_overflow``
    = "disable" (training) zeroes the offending sample's question mask
    instead of raising — see ``assembler._check_question_extent``."""
    max_len = max(len(s["ids"]) for s in samples)
    L = pad_to if pad_to is not None else max_len
    if L < max_len:
        raise ValueError(f"pad_to={L} < longest sample {max_len}")
    b = len(samples)
    n_img = len(samples[0]["image_pos"])
    out = {
        "ids": np.full((b, L), pad_id, np.int32),
        "labels": np.full((b, L), IGNORE, np.int32),
        "attn_mask": np.zeros((b, L), np.int32),
        "text_mask": np.zeros((b, L), np.float32),
        "image_mask": np.zeros((b, L), np.float32),
        "question_mask": np.zeros((b, L), np.float32),
        "image_pos": np.zeros((b, n_img), np.int32),
    }
    for i, s in enumerate(samples):
        n = len(s["ids"])
        out["ids"][i, :n] = s["ids"]
        out["labels"][i, :n] = s["labels"]
        out["attn_mask"][i, :n] = 1
        out["text_mask"][i, :n] = s["text_mask"]
        out["image_mask"][i, :n] = s["image_mask"]
        qm = s["question_mask"]
        if max_question_tokens is not None:
            from moka_tpu_torch.data.assembler import _check_question_extent
            if _check_question_extent(qm, max_question_tokens,
                                      question_overflow):
                qm = np.zeros_like(qm)
        out["question_mask"][i, :n] = qm
        if len(s["image_pos"]) != n_img:
            raise ValueError("image token count must be static per batch")
        out["image_pos"][i] = s["image_pos"]
    # shared arange positions (train.py:267-318)
    out["positions"] = np.broadcast_to(
        np.arange(L, dtype=np.int32), (b, L)).copy()
    return out


def target_spans_from_markers(ids: np.ndarray, inst_end_seq: np.ndarray,
                              eos_id: int) -> np.ndarray:
    """labels: supervise tokens strictly between each ``[/INST]`` marker
    sequence and the following ``</s>`` (inclusive of eos) —
    ``tokenizer_target`` (train.py:116-156)."""
    ids = np.asarray(ids)
    labels = np.full(len(ids), IGNORE, np.int64)
    m = len(inst_end_seq)
    i = 0
    while i <= len(ids) - m:
        if np.array_equal(ids[i:i + m], inst_end_seq):
            j = i + m
            while j < len(ids) and ids[j] != eos_id:
                labels[j] = ids[j]
                j += 1
            if j < len(ids):
                labels[j] = ids[j]  # supervise the </s> too
            i = j + 1
        else:
            i += 1
    return labels.astype(np.int64)
