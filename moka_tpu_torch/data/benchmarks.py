"""VT benchmark eval datasets: MMBench / MME / POPE / SEED (port of
``moka_tpu/data/benchmarks.py``).

Reference: ``VisualText/eval_benchmarks/{mmbench/mmbench.py, mme/mme.py,
pope/pope.py, seed/seed.py}``.  Prompt construction reproduced verbatim:

  * MMBench (``mmbench.py:95-140``): TSV with base64 images + A-E options +
    optional hint; 'Hint: ...\\nQuestion: ...\\nOptions:\\n(A) ...' + the
    fixed select-the-option instruction.
  * MME (``mme.py:89-120``): per-subtask dirs of image + .txt QA pairs split
    on 'Please answer yes or no.'.
  * POPE (``pope.py:85-88,159-163``): HF dataset rows {question, answer,
    image}; yes/no prompt.
  * SEED (``seed.py:100-134``): SEED-Bench.json questions with
    choice_a..d over SEED-Bench-image/.

All datasets yield {prompt (chat-templated, with <image> markers), answer,
image (3,224,224) float32, meta}; ``collate_vt_eval`` assembles left-padded
batches through the standard VT sample assembly for generation."""

from __future__ import annotations

import base64
import io
import json
import os

import numpy as np

from moka_tpu_torch.data.datasets import llama2_chat_prompt
from moka_tpu_torch.data.video import CLIP_MEAN, CLIP_STD

OPTION_PROMPT = ("\nPlease select the correct answer from the options "
                 "above. Output only the selected option in the format "
                 "(A), (B), (C), or (D). No explanation or extra text.")
IMAGE_HEADER = "\n This is an image:\n<image_start><image><image_end>\n"


def _img_from_pil(img, size=224) -> np.ndarray:
    from PIL import Image
    img = img.convert("RGB").resize((size, size), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    return ((arr - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)


class MMBenchDataset:
    def __init__(self, tsv_path: str, image_size: int = 224):
        self.image_size = image_size
        import pandas as pd
        self.df = pd.read_csv(tsv_path, sep="\t")

    def __len__(self):
        return len(self.df)

    def _get(self, idx, key):
        if key not in self.df.columns:
            return None
        v = self.df.iloc[idx][key]
        try:
            import pandas as pd
            if pd.isna(v):
                return None
        except Exception:
            pass
        return v

    def __getitem__(self, idx):
        row = self.df.iloc[idx]
        question = row["question"]
        options = {c: self._get(idx, c) for c in "ABCDE"
                   if self._get(idx, c) is not None}
        hint = self._get(idx, "hint")
        if hint is not None:
            question = f"Hint: {hint}\nQuestion: {question}\nOptions:"
        else:
            question = f"Question: {question}\nOptions:"
        for key, item in options.items():
            question += f"\n({key}) {item}"
        question = question + "\n" + OPTION_PROMPT.lstrip("\n")
        final_question = IMAGE_HEADER + question
        from PIL import Image
        img = Image.open(io.BytesIO(base64.b64decode(row["image"])))
        return {
            "prompt": final_question,
            "answer": self._get(idx, "answer"),
            "image": _img_from_pil(img, self.image_size),
            "meta": {"index": int(row["index"]) if "index" in self.df.columns
                     else idx, "subtask": "mmbench", "image_path": None,
                     "question": final_question},
        }


class MMEDataset:
    def __init__(self, data_root: str, image_size: int = 224):
        self.image_size = image_size
        self.samples = []
        for subtask in sorted(os.listdir(data_root)):
            subdir = os.path.join(data_root, subtask)
            if not os.path.isdir(subdir):
                continue
            for fname in sorted(os.listdir(subdir)):
                if fname.endswith(".txt"):
                    continue
                qa_path = os.path.join(subdir, fname[:-4] + ".txt")
                if not os.path.exists(qa_path):
                    continue
                image_path = os.path.join(subdir, fname)
                with open(qa_path) as f:
                    for qa in f:
                        qa = qa.strip()
                        if "Please answer yes or no." not in qa:
                            continue
                        q, a = qa.split("Please answer yes or no.")
                        self.samples.append({
                            "question": q.strip(), "answer": a.strip(),
                            "image_path": image_path, "subtask": subtask})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        s = self.samples[idx]
        from PIL import Image
        img = Image.open(s["image_path"])
        prompt = ("This is an image:\n<image_start><image><image_end>\n"
                  "Please answer this question with yes or no, and no other "
                  "content. Question: " + s["question"])
        return {"prompt": prompt, "answer": s["answer"],
                "image": _img_from_pil(img, self.image_size),
                "meta": {"subtask": s["subtask"],
                         "image_path": s["image_path"],
                         "question": s["question"]}}


class POPEDataset:
    """POPE rows: {question, answer, image (PIL), image_source}."""

    def __init__(self, rows, image_size: int = 224):
        self.image_size = image_size
        self.rows = rows

    @staticmethod
    def from_hf(path: str, image_size: int = 224) -> "POPEDataset":
        from datasets import load_dataset
        return POPEDataset(load_dataset(path=path)["test"],
                           image_size=image_size)

    @staticmethod
    def from_jsonl(path: str, image_root: str) -> "POPEDataset":
        rows = []
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                r["image_path"] = os.path.join(image_root,
                                               r.get("image",
                                                     r.get("image_source")))
                rows.append(r)
        return POPEDataset(rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        s = self.rows[idx]
        from PIL import Image
        img = s.get("image")
        if img is None or isinstance(img, str):
            img = Image.open(s.get("image_path", img))
        prompt = ("This is an image:\n<image_start><image><image_end>\n"
                  "Please answer this question with yes or no, and no other "
                  "content. Question: " + s["question"])
        return {"prompt": prompt, "answer": s["answer"],
                "image": _img_from_pil(img, self.image_size),
                "meta": {"subtask": "pope",
                         "image_path": s.get("image_source",
                                             s.get("image_path", "")),
                         "question": s["question"]}}


class SEEDDataset:
    def __init__(self, json_path: str, image_root: str,
                 image_size: int = 224):
        self.image_size = image_size
        with open(json_path) as f:
            self.samples = json.load(f)["questions"]
        self.image_root = image_root

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        s = self.samples[idx]
        inst = ("This is an image:\n<image_start><image><image_end>. "
                "Question: " + s["question"] + "\nOptions:")
        for letter, key in zip("ABCD", ("choice_a", "choice_b", "choice_c",
                                        "choice_d")):
            inst += f"\n({letter}) {s[key]}"
        inst += OPTION_PROMPT
        from PIL import Image
        img = Image.open(os.path.join(self.image_root, s["data_id"]))
        return {"prompt": inst, "answer": s["answer"],
                "image": _img_from_pil(img, self.image_size),
                "meta": {"subtask": "seed", "image_path": s["data_id"],
                         "question": inst}}


def build_eval_batch(items: list[dict], tokenize, num_image_tokens: int,
                     pad_to: int | None = None) -> dict:
    """Chat-template + expand <image> x num_image_tokens + assemble a
    LEFT-padded generation batch (eval runs generation, so left padding —
    the train-side right-pad collator is ``vt_dataset.collate_vt``)."""
    from moka_tpu_torch.data import assembler as asm

    assembled, images = [], []
    for it in items:
        prompt = llama2_chat_prompt(it["prompt"])
        ids = np.asarray(tokenize.encode(prompt), np.int64)
        labels = np.full(len(ids), -100, np.int64)
        assembled.append(asm.assemble_sample(
            ids, labels, tokenize.token_to_id, tokenize.pad_id,
            n_video_tokens=num_image_tokens, n_audio_tokens=0))
        images.append(it["image"])
    batch = asm.pad_batch(assembled, tokenize.pad_id, pad_to=pad_to)
    batch["pixel_values"] = np.stack(images)
    # VT mask naming for the llava model
    batch["text_mask"] = batch["modality_masks"][0]
    batch["image_mask"] = batch["modality_masks"][1]
    batch["image_pos"] = batch.pop("video_pos")
    batch.pop("audio_pos", None)
    batch.pop("modality_masks")
    return batch
