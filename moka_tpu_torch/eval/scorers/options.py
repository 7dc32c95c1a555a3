"""Option-letter / yes-no scorers + per-rank JSONL merging.

Reimplements ``VisualText/eval_benchmarks/{mmbench/eval_mmbench.py,
seed/eval_seed.py, pope/cal_pope.py}``: merge ``result_rank*.jsonl`` shards,
normalize the first generated token to an option letter ('a ' -> '(a)') or
yes/no, substring-match against the gold answer."""

from __future__ import annotations

import json
import os


def merge_rank_files(result_dir: str, out_name: str = "merged.jsonl") -> str:
    """Concatenate every '*result*' jsonl shard (eval_mmbench.py:7-29)."""
    merged = []
    for fname in sorted(os.listdir(result_dir)):
        if "result" in fname and fname.endswith(".jsonl"):
            with open(os.path.join(result_dir, fname)) as f:
                merged.extend(json.loads(l) for l in f if l.strip())
    out_path = os.path.join(result_dir, out_name)
    with open(out_path, "w") as f:
        for item in merged:
            f.write(json.dumps(item) + "\n")
    return out_path


def normalize_option(pred: str) -> str | None:
    """'A </s>' -> '(a)' (eval_mmbench.py:41-53)."""
    pred = pred.strip().lower()
    for letter in "abcde":
        if f"{letter} " in pred:
            return f"({letter})"
    return None


def score_option_rows(rows: list[dict]) -> dict:
    correct = total = 0
    for sample in rows:
        total += 1
        answer = sample["answer"].strip().lower()
        pred = normalize_option(sample["output"][0])
        if pred is None:
            continue
        if answer in pred:
            correct += 1
    return {"accuracy": 100.0 * correct / total if total else 0.0,
            "total": total, "correct": correct}


def score_yesno_rows(rows: list[dict]) -> dict:
    """POPE (cal_pope.py:32-56)."""
    correct = total = 0
    for sample in rows:
        total += 1
        answer = sample["answer"].strip().lower()
        pred = sample["output"][0].strip().lower()
        if "yes" in pred:
            pred = "yes"
        elif "no" in pred:
            pred = "no"
        else:
            continue
        if answer in pred:
            correct += 1
    return {"accuracy": 100.0 * correct / total if total else 0.0,
            "total": total, "correct": correct}


def score_option_file(path: str) -> dict:
    rows = [json.loads(l) for l in open(path) if l.strip()]
    return score_option_rows(rows)


def score_yesno_file(path: str) -> dict:
    rows = [json.loads(l) for l in open(path) if l.strip()]
    return score_yesno_rows(rows)
