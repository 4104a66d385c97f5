"""ScienceQA GPT-4 requery merge (ref llava/eval/eval_science_qa_gpt4_requery.py):
three answer sources per problem — our model, GPT-4, and a requery pass — with
the requery answer preferred when it parses, falling back to ours. Prints the
same per-source accuracy breakdown and writes an sqa_results JSON.

The port's own copy of ``llava_plus_tpu/eval/eval_science_qa_gpt4_requery.py``.
"""

import argparse
import json
import os
import re
from collections import defaultdict

from llava_plus_torch.eval.eval_science_qa import get_pred_idx

_ANSWER_RE = re.compile(r"The answer is ([A-Z]).")


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str, required=True)
    parser.add_argument("--gpt4-result", type=str, required=True)
    parser.add_argument("--requery-result", type=str, required=True)
    parser.add_argument("--our-result", type=str, required=True)
    parser.add_argument("--output-result", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--options", type=list,
                        default=["A", "B", "C", "D", "E"])
    return parser.parse_args()


def parse_answer(text: str) -> str:
    res = _ANSWER_RE.findall(text)
    return res[0] if len(res) == 1 else "FAILED"


def main():
    args = get_args()
    split_indices = json.load(
        open(os.path.join(args.base_dir, "pid_splits.json"))
    )[args.split]
    problems = json.load(open(os.path.join(args.base_dir, "problems.json")))
    split_problems = {idx: problems[idx] for idx in split_indices}

    ours = {p["question_id"]: p
            for p in map(json.loads, open(args.our_result))}
    requery = {p["question_id"]: p
               for p in map(json.loads, open(args.requery_result))}
    gpt4 = json.load(open(args.gpt4_result))["outputs"]

    results = defaultdict(int)
    sqa_results = {"acc": None, "correct": None, "count": None,
                   "results": {}, "outputs": {}}

    for prob_id, prob in split_problems.items():
        our_pred = ours[prob_id]["text"]
        gpt4_pred = gpt4[prob_id]
        if prob_id in requery:
            requery_pred = requery[prob_id]["text"]
        else:
            results["missing_requery"] += 1
            requery_pred = "MISSING"

        our_answer = parse_answer(our_pred)
        gpt4_answer = parse_answer(gpt4_pred)
        requery_answer = parse_answer(requery_pred)

        our_idx = get_pred_idx(our_answer, prob["choices"], args.options)
        gpt4_idx = get_pred_idx(gpt4_answer, prob["choices"], args.options)
        requery_idx = get_pred_idx(requery_answer, prob["choices"], args.options)

        results["total"] += 1
        if gpt4_answer == "FAILED":
            results["gpt4_failed"] += 1
            if gpt4_idx == prob["answer"]:
                results["gpt4_correct"] += 1
            if our_idx == prob["answer"]:
                results["gpt4_ourvisual_correct"] += 1
        elif gpt4_idx == prob["answer"]:
            results["gpt4_correct"] += 1
            results["gpt4_ourvisual_correct"] += 1

        if our_idx == prob["answer"]:
            results["our_correct"] += 1

        if requery_answer == "FAILED":
            sqa_results["results"][prob_id] = our_idx
            if our_idx == prob["answer"]:
                results["requery_correct"] += 1
        else:
            sqa_results["results"][prob_id] = requery_idx
            if requery_idx == prob["answer"]:
                results["requery_correct"] += 1

        if gpt4_idx == prob["answer"] or our_idx == prob["answer"]:
            results["correct_upperbound"] += 1

    total = results["total"]
    for name, key in [("Our", "our_correct"), ("GPT-4", "gpt4_correct"),
                      ("GPT-4 NO-ANS (RANDOM)", "gpt4_failed"),
                      ("GPT-4-OursVisual", "gpt4_ourvisual_correct"),
                      ("Requery", "requery_correct"),
                      ("Correct upper", "correct_upperbound")]:
        print(f"Total: {total}, {name}: {results[key]}, "
              f"Rate: {results[key] / total * 100:.2f}%")

    sqa_results["acc"] = results["requery_correct"] / total * 100
    sqa_results["correct"] = results["requery_correct"]
    sqa_results["count"] = total
    with open(args.output_result, "w") as f:
        json.dump(sqa_results, f, indent=2)


if __name__ == "__main__":
    main()
