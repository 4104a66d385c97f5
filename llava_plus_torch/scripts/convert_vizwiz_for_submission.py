"""VizWiz answers -> submission JSON (the port's copy of scripts/convert_vizwiz_for_submission.py)."""

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
    parser.add_argument("--annotation-file", type=str, required=True)
    parser.add_argument("--result-file", type=str, required=True)
    parser.add_argument("--result-upload-file", type=str, required=True)
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    os.makedirs(os.path.dirname(args.result_upload_file), exist_ok=True)

    results = [json.loads(line) for line in open(args.result_file)]
    results = {x["question_id"]: x["text"] for x in results}

    annotations = json.load(open(args.annotation_file))
    if isinstance(annotations, dict):
        annotations = annotations.get("annotations", annotations)

    answer_processor = EvalAIAnswerProcessor()
    all_answers = []
    for x in annotations:
        all_answers.append({
            "image": x["image"],
            "answer": answer_processor(results.get(x["question_id"], "")),
        })
    with open(args.result_upload_file, "w") as f:
        json.dump(all_answers, f)
