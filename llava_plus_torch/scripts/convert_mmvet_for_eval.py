"""MM-Vet answers -> evaluator JSON (the port's copy of scripts/convert_mmvet_for_eval.py)."""

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, required=True)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    cur_result = {}
    for line in open(args.src):
        data = json.loads(line)
        qid = data["question_id"]
        cur_result[f"v1_{qid}"] = data["text"]

    with open(args.dst, "w") as f:
        json.dump(cur_result, f, indent=2)


if __name__ == "__main__":
    main()
