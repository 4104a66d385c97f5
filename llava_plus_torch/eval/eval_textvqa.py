"""TextVQA scorer (ref llava/eval/eval_textvqa.py): match predictions to the
annotation file, normalize with the EvalAI processor, report soft accuracy.

The port's own copy of ``llava_plus_tpu/eval/eval_textvqa.py``.
"""

import argparse
import json
import os
import re

from llava_plus_torch.eval.m4c_evaluator import TextVQAAccuracyEvaluator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str, required=True)
    parser.add_argument("--result-file", type=str)
    parser.add_argument("--result-dir", type=str)
    return parser


def get_args():
    return build_parser().parse_args()


def prompt_processor(prompt: str) -> str:
    if prompt.startswith("OCR tokens: "):
        pattern = r"Question: (.*?) Short answer:"
        match = re.search(pattern, prompt, re.DOTALL)
        question = match.group(1)
    elif "Reference OCR token: " in prompt and len(prompt.split("\n")) == 3:
        if prompt.startswith("Reference OCR token:"):
            question = prompt.split("\n")[1]
        else:
            question = prompt.split("\n")[0]
    elif len(prompt.split("\n")) == 2:
        question = prompt.split("\n")[0]
    else:
        raise ValueError("unexpected prompt format: " + prompt)
    return question.lower()


def eval_single(annotation_file, result_file):
    experiment_name = os.path.splitext(os.path.basename(result_file))[0]
    print(experiment_name)
    annotations = json.load(open(annotation_file))["data"]
    annotations = {
        (a["image_id"], a["question"].lower()): a for a in annotations
    }
    results = [json.loads(line) for line in open(result_file)]

    pred_list = []
    for result in results:
        annotation = annotations[
            (result["question_id"], prompt_processor(result["prompt"]))
        ]
        pred_list.append({
            "pred_answer": result["text"],
            "gt_answers": annotation["answers"],
        })

    evaluator = TextVQAAccuracyEvaluator()
    acc = evaluator.eval_pred_list(pred_list)
    print("Samples: {}\nAccuracy: {:.2f}%\n".format(len(pred_list), 100.0 * acc))
    return acc


if __name__ == "__main__":
    args = get_args()
    if args.result_file is not None:
        eval_single(args.annotation_file, args.result_file)
    if args.result_dir is not None:
        for result_file in sorted(os.listdir(args.result_dir)):
            if not result_file.endswith(".jsonl"):
                print(f"Skipping {result_file}")
                continue
            eval_single(args.annotation_file,
                        os.path.join(args.result_dir, result_file))
