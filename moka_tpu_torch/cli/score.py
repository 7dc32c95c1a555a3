"""Scoring CLI: merge per-rank shards and run a benchmark scorer (port of
``moka_tpu/cli/score.py``), on the port's scorers:

    python -m moka_tpu_torch.cli.score --task avqa --path merged.jsonl
    python -m moka_tpu_torch.cli.score --task ave --path ... --annotations ...
    python -m moka_tpu_torch.cli.score --task mmbench|seed|pope|mme --path ...
    python -m moka_tpu_torch.cli.score --merge-dir eval_out/   (merge first)

Host-side only: it reads JSONL and needs no device.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser("moka-score")
    p.add_argument("--task", required=True,
                   choices=["avqa", "ave", "mmbench", "seed", "pope", "mme"])
    p.add_argument("--path", help="merged.jsonl (or shard dir w/ --merge-dir)")
    p.add_argument("--merge-dir", help="directory of result_rank*.jsonl")
    p.add_argument("--annotations", help="AVE Annotations.txt")
    args = p.parse_args(argv)

    from moka_tpu_torch.eval.scorers import ave, avqa, mme, options

    path = args.path
    if args.merge_dir:
        path = options.merge_rank_files(args.merge_dir)

    if args.task == "avqa":
        out = avqa.score_file(path)
    elif args.task == "ave":
        out = ave.score_file(path, args.annotations)
    elif args.task in ("mmbench", "seed"):
        out = options.score_option_file(path)
    elif args.task == "pope":
        out = options.score_yesno_file(path)
    else:
        out = mme.score_file(path)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
