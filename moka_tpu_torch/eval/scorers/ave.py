"""AVE scorer — reimplements
``AudioVisualText/scripts/evaluation/ave_eval.py``: event vocabulary from
``Annotations.txt``, ``<event>/<range>`` primary format plus the
``event (start end)`` fallback, framewise 10-slot labels, plain accuracy."""

from __future__ import annotations

import json
import re

import numpy as np


def load_vocab(annotations_path: str) -> dict:
    vocab = set()
    with open(annotations_path) as f:
        for line in f:
            line = line.strip()
            if line:
                vocab.add(line.split("&")[0])
    mapping = {"none": 0}
    for i, event in enumerate(list(vocab)):
        mapping[event.lower()] = i + 1
    return mapping


def score_rows(rows: list[dict], mapping: dict) -> dict:
    n = len(rows) * 10
    pre = np.zeros(n)
    real = np.zeros(n)
    c = 0
    nums = 0
    for sample in rows:
        answer = sample["output"]
        pred = sample["predict"]
        m = re.findall(r"event:(.*?)start_time", answer)
        event = m[0].strip().lower()
        answer = answer.replace("</s>", "").strip()
        start_time = int(answer.split(" ")[-2].split(":")[-1])
        end_time = int(answer.split(" ")[-1].split(":")[-1])

        m = re.findall(r"<event>(.*?)</event>", pred)
        if len(m) != 1:
            continue
        event_content = m[0].strip()
        pred_event_temp = event_content.lower()
        pred_ranges = []
        if pred_event_temp in mapping:
            pred_event = pred_event_temp
            ranges = re.findall(r"<range>(.*?)</range>", pred)
            if not ranges:
                continue
            for range_str in ranges:
                try:
                    parts = range_str.strip().split(",")
                    if len(parts) != 2:
                        raise ValueError
                    pred_ranges.append((int(parts[0].strip()),
                                        int(parts[1].strip())))
                except Exception:
                    continue
            if not pred_ranges:
                continue
        else:
            # secondary format: "Event name (0 10), (12 15)"
            try:
                time_matches = re.findall(r"\(\s*(\d+)\s+(\d+)\s*\)",
                                          event_content)
                if not time_matches:
                    continue
                for s, e in time_matches:
                    pred_ranges.append((int(s), int(e)))
                first = re.search(r"\(\s*\d+\s+\d+\s*\)", event_content)
                if first is None:
                    continue
                pred_event = event_content[:first.start()].strip() \
                    .rstrip(",").lower()
                if pred_event not in mapping:
                    continue
            except Exception:
                continue

        nums += 1
        for i in range(10):
            if start_time <= i <= end_time:
                real[c] = mapping[event]
            if any(ps <= i <= pe for ps, pe in pred_ranges):
                pre[c] = mapping[pred_event]
            c += 1

    # "accuracy" reproduces the reference quirk exactly (ave_eval.py:23,
    # N = rows*10 with invalid rows leaving 0==0 tail matches that COUNT as
    # correct).  That is only meaningful on the full test set; for partial
    # shards "accuracy_valid_frames" scores the frames actually written.
    acc = float(np.mean(real == pre)) if n else 0.0
    acc_valid = float(np.mean(real[:c] == pre[:c])) if c else 0.0
    return {"accuracy": acc, "valid": nums, "total": len(rows),
            "frames_scored": c,
            "accuracy_valid_frames": acc_valid,
            "tail_assumed_correct": n - c}


def score_file(path: str, annotations_path: str) -> dict:
    mapping = load_vocab(annotations_path)
    rows = [json.loads(l) for l in open(path) if l.strip()]
    return score_rows(rows, mapping)
