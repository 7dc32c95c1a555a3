"""MME scorer — reimplements ``VisualText/eval_benchmarks/mme/mme_score.py``
directly over the merged jsonl (the reference routes through the official
MME txt format; rows carry 'subtask' so the detour is unnecessary):
per-subtask acc + acc_plus (both questions of an image correct), subtask
score = 100*(acc + acc_plus), perception total over 10 subtasks."""

from __future__ import annotations

import json
from collections import defaultdict

PERCEPTION_TASKS = ["existence", "count", "position", "color", "posters",
                    "celebrity", "scene", "landmark", "artwork", "OCR"]
COGNITION_TASKS = ["commonsense_reasoning", "numerical_calculation",
                   "text_translation", "code_reasoning"]


def parse_pred_ans(pred_ans: str) -> str:
    """(mme_score.py:24-38)"""
    if pred_ans in ("yes", "no"):
        return pred_ans
    prefix = pred_ans[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def score_rows(rows: list[dict]) -> dict:
    """Note on the published number: the reference README reports
    MME_perception 1105.51, but its released ``merged.jsonl`` does not
    reproduce it under ANY of the reference's own paths (round-2 recheck):

      * this scorer (official prefix parse_pred_ans + per-image acc_plus,
        deduped): 1139.14;
      * the reference's literal ``eval_mme.py`` txt conversion — substring
        'yes' anywhere -> yes, else 'no' (its ``elif ('no' or 'not' in
        predict)`` is always truthy), odd-row-per-image dropping, pair
        chunking — then the official calculation: 1138.15;
      * deduping wrap-around rows first: removes 2 of 2376 rows, same
        score.

    The released predictions are therefore from a different run than the
    README table; 1139.14 is pinned as the golden value for THESE
    predictions (tests/test_scorers_golden.py)."""
    seen = set()
    by_task = defaultdict(lambda: defaultdict(list))
    for r in rows:
        key = (r["subtask"], r["image_path"], r["question"])
        if key in seen:
            continue
        seen.add(key)
        pred = r["output"][0] if isinstance(r["output"], list) else r["output"]
        pred = " ".join(str(pred).split()).strip().lower()
        by_task[r["subtask"]][r["image_path"]].append(
            (r["answer"].strip().lower(), parse_pred_ans(pred)))

    task_scores = {}
    for task, images in by_task.items():
        gts, preds = [], []
        acc_plus_correct = 0
        for img, qa in images.items():
            img_correct = 0
            for gt, pred in qa:
                gts.append(gt)
                preds.append(pred)
                if gt == pred:
                    img_correct += 1
            if img_correct == 2:
                acc_plus_correct += 1
        acc = sum(g == p for g, p in zip(gts, preds)) / len(gts)
        acc_plus = acc_plus_correct / len(images)
        task_scores[task] = 100.0 * (acc + acc_plus)

    perception = sum(task_scores.get(t, 0.0) for t in PERCEPTION_TASKS)
    cognition = sum(task_scores.get(t, 0.0) for t in COGNITION_TASKS)
    return {"perception": perception, "cognition": cognition,
            "subtasks": dict(task_scores)}


def score_file(path: str) -> dict:
    rows = [json.loads(l) for l in open(path) if l.strip()]
    return score_rows(rows)
