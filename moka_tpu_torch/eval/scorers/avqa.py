"""MUSIC-AVQA scorer — reimplements
``AudioVisualText/scripts/evaluation/avqa_eval.py`` byte-for-byte:
closed 42-answer vocabulary, ``<answer>...</answer>`` extraction, substring
match, per-question-type buckets."""

from __future__ import annotations

import json
import re

ANSWER_LIST = [
    'zero', 'pipa', 'middle', 'congas', 'eight', 'saxophone', 'tuba', 'no',
    'guzheng', 'left', 'ten', 'four', 'five', 'nine', 'more than ten',
    'drum', 'suona', 'indoor', 'two', 'simultaneously', 'piano', 'right',
    'acoustic_guitar', 'trumpet', 'seven', 'outdoor', 'six', 'yes', 'violin',
    'flute', 'clarinet', 'bagpipe', 'one', 'three', 'accordion', 'cello',
    'electric_bass', 'erhu', 'ukulele', 'bassoon', 'banjo', 'xylophone']

BUCKETS = [("Audio", "Counting"), ("Audio", "Comparative"),
           ("Visual", "Counting"), ("Visual", "Location"),
           ("Audio-Visual", "Existential"), ("Audio-Visual", "Counting"),
           ("Audio-Visual", "Location"), ("Audio-Visual", "Comparative"),
           ("Audio-Visual", "Temporal")]


def score_rows(rows: list[dict]) -> dict:
    buckets = {b: [] for b in BUCKETS}
    correct = total = 0
    for sample in rows:
        answer = sample["output"].split("</s>")[0]
        pred = sample["predict"]
        qtype = sample["question_type"]
        matches = re.findall(r"<answer>(.*?)</answer>", pred)
        if len(matches) != 1:
            continue
        pred = matches[0].strip().strip().lower()
        answer = answer.strip().lower()
        if pred not in ANSWER_LIST:
            continue
        pred_true = 1 if answer in pred else 0
        total += 1
        correct += pred_true
        key = (qtype[0], qtype[1])
        if key in buckets:
            buckets[key].append(pred_true)

    def acc(vals):
        return 100.0 * sum(vals) / len(vals) if vals else 0.0

    out = {f"{a}/{b}": acc(v) for (a, b), v in buckets.items()}
    for major in ("Audio", "Visual", "Audio-Visual"):
        vals = sum((v for (a, _), v in buckets.items() if a == major), [])
        out[major] = acc(vals)
    out["overall"] = 100.0 * correct / total if total else 0.0
    out["total"] = total
    out["correct"] = correct
    return out


def score_file(path: str) -> dict:
    rows = [json.loads(l) for l in open(path) if l.strip()]
    return score_rows(rows)
