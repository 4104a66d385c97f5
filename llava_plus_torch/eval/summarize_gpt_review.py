"""Aggregate GPT-judge reviews into per-category relative scores
(ref llava/eval/summarize_gpt_review.py).

The port's own copy of ``llava_plus_tpu/eval/summarize_gpt_review.py``.
"""

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def main(args):
    if args.ignore is not None:
        args.ignore = [int(x) for x in args.ignore]

    if args.files is not None and len(args.files) > 0:
        review_files = args.files
    else:
        review_files = [
            x for x in os.listdir(args.dir)
            if x.endswith(".jsonl") and (
                x.startswith("gpt4_text") or x.startswith("reviews_")
            )
        ]

    for review_file in sorted(review_files):
        config = os.path.basename(review_file).replace(".jsonl", "")
        if args.select is not None and any(
            x not in config for x in args.select
        ):
            continue
        scores = defaultdict(list)
        with open(os.path.join(args.dir, review_file) if args.dir else review_file) as f:
            for review_str in f:
                review = json.loads(review_str)
                if args.ignore is not None and review.get("question_id") in args.ignore:
                    continue
                if "category" in review:
                    scores[review["category"]].append(review["tuple"])
                    scores["all"].append(review["tuple"])
                else:
                    ques_id = review.get("question_id", 0)
                    scores["all"].append(review["tuple"])
        print(config)
        for k, v in sorted(scores.items()):
            stats = np.asarray(v).mean(0).tolist()
            stats = [round(x, 3) for x in stats]
            print(k, round(stats[1] / stats[0] * 100, 1), round(stats[0] * 10, 1),
                  round(stats[1] * 10, 1))
        print("=================================")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dir", default=None)
    parser.add_argument("-f", "--files", nargs="*", default=None)
    parser.add_argument("-s", "--select", nargs="*", default=None)
    parser.add_argument("-i", "--ignore", nargs="*", default=None)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
