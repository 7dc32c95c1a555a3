"""AVT datasets: MUSIC-AVQA / AVE fine-tuning, captioning pretraining
(port of ``moka_tpu/data/datasets.py``).

Reference: ``AudioVisualText/dataset/unified_dataset.py`` (UnifiedDataset /
UnifiedTestDataset + collators) and ``dataset/pretrain_dataset.py``.
Prompt strings, chat templating, frame/segment sampling, and label layout
are preserved exactly; decord/librosa are replaced by cv2 + the native
fbank frontend.  Everything here is host-side numpy feeding the assembler.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import numpy as np

from moka_tpu_torch.data import assembler as asm
from moka_tpu_torch.data.audio import load_audio, segment_windows
from moka_tpu_torch.data.fbank import beats_fbank
from moka_tpu_torch.data.video import clip_preprocess, read_video_frames

LLAMA2_SYSTEM = "You are a helpful assistant."

AVQA_INSTRUCTION = ("This is a video:\n<video_start><video><video_end>\n"
                    "This is an audio:\n<audio_start><audio><audio_end>\n"
                    "<question_start>Please answer this question: "
                    "{question}<question_end>")
AVE_INSTRUCTION = ("This is a video:\n<video_start><video><video_end>\n"
                   "This is an audio:\n<audio_start><audio><audio_end>\n"
                   "<question_start>Please describe the events and time "
                   "range that occurred in the video.<question_end>")


def llama2_chat_prompt(user: str, system: str = LLAMA2_SYSTEM) -> str:
    """The exact template the reference's chat tokenizer produces (visible in
    the released predictions: ``inference_ave.jsonl`` instruction field)."""
    return (f"<s>[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{user} [/INST]")


@dataclasses.dataclass
class Tokenize:
    """Tokenizer adapter: callers supply ``encode(text)->list[int]`` that
    understands the 11 special tokens (``initialize_MM_tokenizer``)."""
    encode: Callable[[str], list[int]]
    token_to_id: dict
    pad_id: int = 0
    eos_id: int = 2


class UnifiedDataset:
    """Stage-2 fine-tune dataset (``unified_dataset.py:25-241``)."""

    def __init__(self, tokenize: Tokenize, mode: str = "train",
                 avqa_annotation: str | None = None,
                 ave_annotation: str | None = None,
                 ave_data_root: str | None = None,
                 video_frame_nums: int = 10, image_size: int = 224,
                 n_video_tokens: int = 320, n_audio_tokens: int = 320,
                 qformer_tokenize: Callable[[str], list[int]] | None = None,
                 qformer_question_len: int = 32,
                 max_question_tokens: int | None = None):
        """qformer_tokenize: optional BERT-vocab ``encode(text)->ids`` for
        instruction-aware Q-Former projection (the reference supports passing
        the question into the Q-Former's text stream,
        ``multimodal_encoder.py:132-151``, but its live stages pass None —
        ``unified_arch.py:185,196,212``).  When set, ``collate`` emits
        ``qformer_question_ids``/``qformer_question_mask`` of static shape
        (b, qformer_question_len), consumed by ``unified.encode_modalities``."""
        self.tok = tokenize
        self.mode = mode
        self.qformer_tokenize = qformer_tokenize
        self.qformer_question_len = qformer_question_len
        self.video_frame_nums = video_frame_nums
        self.image_size = image_size
        self.n_video_tokens = n_video_tokens
        self.n_audio_tokens = n_audio_tokens
        # mirror of MokaSpec.max_question_tokens: fail at assembly rather
        # than silently truncate the rank-attention key set
        self.max_question_tokens = max_question_tokens
        self.samples: list[dict] = []
        if avqa_annotation:
            self._add_avqa(avqa_annotation)
        if ave_annotation:
            self._add_ave(ave_annotation, ave_data_root or
                          os.path.dirname(ave_annotation))

    def _add_avqa(self, path: str) -> None:
        with open(path) as f:
            samples = json.load(f)
        for s in samples:
            self.samples.append({
                "vid": s["video_id"], "qid": s["question_id"],
                "type": s["type"], "video_path": s["video_path"],
                "audio_path": s["audio_path"], "output": s["label"],
                "task_name": "avqa",
                "question": s["question"],
                "instruction": AVQA_INSTRUCTION.format(
                    question=s["question"]),
            })

    @staticmethod
    def _existing(base: str, exts: tuple[str, ...]) -> str:
        for ext in exts:
            cand = base + ext
            if os.path.exists(cand):
                return cand
        return base + exts[0]

    def _add_ave(self, path: str, root: str) -> None:
        """Reference layout (mp3/mp4, ``unified_dataset.py:96-105``) with
        wav/npy/avi fallbacks — mp3 is not decoded here
        (``data/audio.py``)."""
        with open(path) as f:
            samples = json.load(f)
        for s in samples:
            vid = s["vid"]
            label_path = os.path.join(root, "converted_label", vid + ".txt")
            self.samples.append({
                "audio_path": self._existing(
                    os.path.join(root, "audio_data", vid),
                    (".mp3", ".wav", ".npy")),
                "video_path": self._existing(
                    os.path.join(root, "AVE", vid), (".mp4", ".avi")),
                "label_path": label_path, "task_name": "ave",
                "instruction": AVE_INSTRUCTION,
            })

    def __len__(self) -> int:
        return len(self.samples)

    def _video(self, path: str) -> np.ndarray:
        frames = read_video_frames(path, self.video_frame_nums,
                                   self.image_size)
        return clip_preprocess(frames, self.image_size)

    def _audio_avqa(self, path: str) -> np.ndarray:
        """60 s track -> 10 windows every 6 s, each 2 s wide (-0.5/+1.5 s
        around t), zero-padded at edges (``unified_dataset.py:174-195``)."""
        wav = load_audio(path, sr=16000)
        segs = segment_windows(wav, total_seconds=60, stride=6,
                               before=0.5, after=1.5)
        return np.stack([beats_fbank(s) for s in segs])

    def _audio_ave(self, path: str) -> np.ndarray:
        """10 x 1 s segments (``unified_dataset.py:219-239``)."""
        wav = load_audio(path, sr=16000)
        segs = segment_windows(wav, total_seconds=10, stride=1,
                               before=0.0, after=1.0)
        return np.stack([beats_fbank(s) for s in segs])

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx]
        output = s.get("output")
        if output is None:
            with open(s["label_path"]) as f:
                output = f.read()
        instruction = llama2_chat_prompt(s["instruction"])
        data = {
            "instruction": instruction,
            "output": output + "</s>",
            "task_name": s["task_name"],
            "meta": {**{k: s[k] for k in ("vid", "qid", "question")
                        if k in s},
                     **({"question_type": s["type"]} if "type" in s
                        else {})},
        }
        data["video"] = self._video(s["video_path"])
        data["audio"] = (self._audio_avqa if s["task_name"] == "avqa" else
                         self._audio_ave)(s["audio_path"])
        if self.qformer_tokenize is not None:
            # AVQA carries the raw question; AVE's "question" is the fixed
            # span between <question_start>/<question_end>
            q = s.get("question")
            if q is None:
                inst = s["instruction"]
                i = inst.find("<question_start>")
                j = inst.find("<question_end>")
                q = inst[i + len("<question_start>"):j] if 0 <= i < j else inst
            data["question_text"] = q
        return data

    def collate(self, items: list[dict], pad_to: int | None = None) -> dict:
        """Tokenize + assemble + left-pad; labels = -100 on instruction,
        supervised on output (+</s>) (``unified_dataset.py:479-528``)."""
        assembled = []
        for it in items:
            inst_ids = self.tok.encode(it["instruction"])
            if self.mode == "train":
                out_ids = self.tok.encode(it["output"])
                ids = np.asarray(inst_ids + out_ids, np.int64)
                labels = np.asarray([-100] * len(inst_ids) + out_ids,
                                    np.int64)
            else:
                ids = np.asarray(inst_ids, np.int64)
                labels = np.full(len(ids), -100, np.int64)
            assembled.append(asm.assemble_sample(
                ids, labels, self.tok.token_to_id, self.tok.pad_id,
                n_video_tokens=self.n_video_tokens,
                n_audio_tokens=self.n_audio_tokens,
                max_question_tokens=self.max_question_tokens,
                # training degrades an overflowing sample to no-cross-attn
                # instead of aborting the run; eval keeps the parity raise
                question_overflow=("disable" if self.mode == "train"
                                   else "raise")))
        batch = asm.pad_batch(assembled, self.tok.pad_id, pad_to=pad_to)
        batch["video"] = np.stack([it["video"] for it in items])
        batch["audio"] = np.stack([it["audio"] for it in items])
        if self.qformer_tokenize is not None:
            n = self.qformer_question_len
            ids = np.zeros((len(items), n), np.int32)
            mask = np.zeros((len(items), n), np.float32)
            for i, it in enumerate(items):
                q = self.qformer_tokenize(it["question_text"])[:n]
                ids[i, :len(q)] = q
                mask[i, :len(q)] = 1.0
            batch["qformer_question_ids"] = ids
            batch["qformer_question_mask"] = mask
        if self.mode != "train":
            batch["meta"] = [it["meta"] for it in items]
            batch["output"] = [it["output"] for it in items]
        return batch


PRETRAIN_IMAGE_PROMPT = ("This is an image:\n<image_start><image>"
                         "<image_end>\nPlease describe this image.")
PRETRAIN_VIDEO_PROMPT = ("This is a video:\n<video_start><video>"
                         "<video_end>\nPlease describe this video.")
PRETRAIN_AUDIO_PROMPT = ("This is an audio:\n<audio_start><audio>"
                         "<audio_end>\nPlease describe this audio.")


class PretrainDataset:
    """Stage-1 captioning dataset (``pretrain_dataset.py:31-265``):
    Video-LLaVA image/video caption JSONs + AudioCaps rows of
    {path, caption}-style entries."""

    def __init__(self, tokenize: Tokenize, entries: list[dict],
                 video_frame_nums: int = 8, image_size: int = 224,
                 n_video_tokens: int = 32, n_audio_tokens: int = 32):
        self.tok = tokenize
        self.entries = entries  # [{kind: image|video|audio, path, caption}]
        self.video_frame_nums = video_frame_nums
        self.image_size = image_size
        self.n_video_tokens = n_video_tokens
        self.n_audio_tokens = n_audio_tokens

    @staticmethod
    def from_jsons(tokenize: Tokenize, image_json: str | None = None,
                   video_json: str | None = None,
                   audio_json: str | None = None, **kw) -> "PretrainDataset":
        entries = []
        for kind, path in (("image", image_json), ("video", video_json),
                           ("audio", audio_json)):
            if path is None:
                continue
            with open(path) as f:
                for row in json.load(f):
                    entries.append({"kind": kind,
                                    "path": row.get("path") or
                                    row.get("image") or row.get("video"),
                                    "caption": row.get("caption") or
                                    row.get("conversations", [{}, {}])[-1]
                                    .get("value", "")})
        return PretrainDataset(tokenize, entries, **kw)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[idx]
        kind = e["kind"]
        prompt = {"image": PRETRAIN_IMAGE_PROMPT,
                  "video": PRETRAIN_VIDEO_PROMPT,
                  "audio": PRETRAIN_AUDIO_PROMPT}[kind]
        data = {"instruction": llama2_chat_prompt(prompt),
                "output": e["caption"] + "</s>", "task_name": kind}
        if kind == "image":
            from moka_tpu_torch.data.video import load_image
            data["video"] = load_image(e["path"], self.image_size)[None]
        elif kind == "video":
            frames = read_video_frames(e["path"], self.video_frame_nums,
                                       self.image_size)
            data["video"] = clip_preprocess(frames, self.image_size)
        else:
            wav = load_audio(e["path"], sr=16000)
            segs = segment_windows(wav, total_seconds=max(
                1, int(len(wav) / 16000)), stride=1, before=0.0, after=1.0)
            data["audio"] = np.stack([beats_fbank(s) for s in segs])
        return data
