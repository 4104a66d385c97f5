"""GQA answers -> official eval format (the port's copy of scripts/convert_gqa_for_eval.py)."""

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, required=True)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    all_answers = []
    for line_idx, line in enumerate(open(args.src)):
        res = json.loads(line)
        question_id = res["question_id"]
        text = res["text"].rstrip(".").lower()
        all_answers.append({"questionId": question_id, "prediction": text})

    with open(args.dst, "w") as f:
        json.dump(all_answers, f)


if __name__ == "__main__":
    main()
