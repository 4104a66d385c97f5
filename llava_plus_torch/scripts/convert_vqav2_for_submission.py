"""VQAv2 answers -> EvalAI submission JSON (the port's copy of scripts/convert_vqav2_for_submission.py)."""

import sys
from pathlib import Path

# allow running as `python llava_plus_torch/scripts/<name>.py` without installing the package
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


import argparse
import json
import os

from llava_plus_torch.eval.m4c_evaluator import EvalAIAnswerProcessor


def parse_args():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", type=str, default="./playground/data/eval/vqav2")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--split", type=str, required=True)
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    src = os.path.join(args.dir, "answers", args.split, args.ckpt, "merge.jsonl")
    test_split = os.path.join(args.dir, f"llava_{args.split}.jsonl")
    dst = os.path.join(args.dir, "answers_upload", args.split, f"{args.ckpt}.json")
    os.makedirs(os.path.dirname(dst), exist_ok=True)

    results = [json.loads(line) for line in open(src)]
    results = {x["question_id"]: x["text"] for x in results}
    test_split_rows = [json.loads(line) for line in open(test_split)]
    split_ids = set([x["question_id"] for x in test_split_rows])

    print(f"total results: {len(results)}, total split: {len(test_split_rows)}")

    all_answers = []
    answer_processor = EvalAIAnswerProcessor()
    for x in test_split_rows:
        if x["question_id"] not in results:
            all_answers.append({"question_id": x["question_id"], "answer": ""})
        else:
            all_answers.append({
                "question_id": x["question_id"],
                "answer": answer_processor(results[x["question_id"]]),
            })
    with open(dst, "w") as f:
        json.dump(all_answers, f)
