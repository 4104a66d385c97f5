"""ScienceQA judged by GPT-4 output merge (ref llava/eval/eval_science_qa_gpt4.py):
prefer our model's answer, fall back to the GPT-4 result when ours failed.

The port's own copy of ``llava_plus_tpu/eval/eval_science_qa_gpt4.py``.
"""

import argparse
import json
import os
import random
import re

from llava_plus_torch.eval.eval_science_qa import get_pred_idx


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str, required=True)
    parser.add_argument("--gpt4-result", type=str, required=True)
    parser.add_argument("--our-result", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--options", type=list,
                        default=["A", "B", "C", "D", "E"])
    return parser.parse_args()


def main():
    args = get_args()
    base_dir = args.base_dir
    split_indices = json.load(
        open(os.path.join(base_dir, "pid_splits.json"))
    )[args.split]
    problems = json.load(open(os.path.join(base_dir, "problems.json")))
    our_predictions = [json.loads(line) for line in open(args.our_result)]
    our_predictions = {p["question_id"]: p for p in our_predictions}
    split_problems = {idx: problems[idx] for idx in split_indices}
    gpt4_predictions = json.load(open(args.gpt4_result))["outputs"]

    correct, total = 0, 0
    for prob_id, prob in split_problems.items():
        if prob_id not in our_predictions:
            continue
        total += 1
        our_pred = our_predictions[prob_id]["text"]
        pattern = re.compile(r"The answer is ([A-Z]).")
        res = pattern.findall(our_pred)
        answer = res[0] if len(res) == 1 else "FAILED"
        if answer == "FAILED" and prob_id in gpt4_predictions:
            res = pattern.findall(gpt4_predictions[prob_id])
            answer = res[0] if len(res) == 1 else random.choice(args.options)
        if get_pred_idx(answer, prob["choices"], args.options) == prob["answer"]:
            correct += 1
    print(f"Total: {total}, Correct: {correct}, "
          f"Accuracy: {correct / total * 100:.2f}%")


if __name__ == "__main__":
    main()
