"""GPT-4 judge for LLaVA-Bench-in-the-Wild (ref
llava/eval/eval_gpt_review_bench.py): pairwise review with per-image caption
context, resumable — already-written review rows are skipped on re-run.

The port's own copy of ``llava_plus_tpu/eval/eval_gpt_review_bench.py``.
"""

import argparse
import json
import os

from llava_plus_torch.eval.eval_gpt_review import get_eval, parse_score


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GPT-based pairwise review.")
    parser.add_argument("-q", "--question")
    parser.add_argument("-c", "--context")
    parser.add_argument("-a", "--answer-list", nargs="+", default=[])
    parser.add_argument("-r", "--rule")
    parser.add_argument("-o", "--output")
    parser.add_argument("--max-tokens", type=int, default=1024)
    return parser


def main():
    args = build_parser().parse_args()

    f_q = open(os.path.expanduser(args.question))
    f_ans1 = open(os.path.expanduser(args.answer_list[0]))
    f_ans2 = open(os.path.expanduser(args.answer_list[1]))
    rule_dict = json.load(open(os.path.expanduser(args.rule)))

    cur_reviews = []
    if os.path.isfile(os.path.expanduser(args.output)):
        cur_reviews = [
            json.loads(line) for line in open(os.path.expanduser(args.output))
        ]

    review_file = open(args.output, "a")
    context_list = [json.loads(line) for line in open(args.context)]
    image_to_context = {c["image"]: c for c in context_list}

    idx = 0
    for ques_js, ans1_js, ans2_js in zip(f_q, f_ans1, f_ans2):
        ques = json.loads(ques_js)
        ans1 = json.loads(ans1_js)
        ans2 = json.loads(ans2_js)

        inst = image_to_context[ques["image"]]
        cap = inst["caption"]
        cap_str = "\n".join(cap) if isinstance(cap, list) else cap

        category = "llava_bench_" + ques["category"]
        if category not in rule_dict:
            raise KeyError(f"Visual QA category not found in rule file: {category}")
        rule = rule_dict[category]
        prompt = rule["prompt"]
        role = rule["role"]
        content = (f"[Context]\n{cap_str}\n\n"
                   f"[Question]\n{ques['text']}\n\n"
                   f"[{role} 1]\n{ans1['text']}\n\n[End of {role} 1]\n\n"
                   f"[{role} 2]\n{ans2['text']}\n\n[End of {role} 2]\n\n"
                   f"[System]\n{prompt}\n\n")
        cur_js = {
            "id": idx + 1,
            "question_id": ques["question_id"],
            "answer1_id": ans1.get("answer_id", ans1.get("question_id")),
            "answer2_id": ans2.get("answer_id", ""),
            "category": category,
        }
        if idx >= len(cur_reviews):
            review = get_eval(content, args.max_tokens)
            cur_js["content"] = review
            cur_js["tuple"] = parse_score(review)
            review_file.write(json.dumps(cur_js) + "\n")
            review_file.flush()
        idx += 1
    review_file.close()


if __name__ == "__main__":
    main()
