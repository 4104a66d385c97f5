"""GPT-4 visual judge (ref llava/eval/eval_gpt_review_visual.py): like
eval_gpt_review but includes captions + boxes context per image.

The port's own copy of ``llava_plus_tpu/eval/eval_gpt_review_visual.py``.
"""

import argparse
import json
import os

from llava_plus_torch.eval.eval_gpt_review import get_eval, parse_score


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-q", "--question")
    parser.add_argument("-c", "--context")
    parser.add_argument("-a", "--answer-list", nargs="+", default=[])
    parser.add_argument("-r", "--rule")
    parser.add_argument("-o", "--output")
    parser.add_argument("--max-tokens", type=int, default=1024)
    args = parser.parse_args()

    f_q = open(os.path.expanduser(args.question))
    f_ans1 = open(os.path.expanduser(args.answer_list[0]))
    f_ans2 = open(os.path.expanduser(args.answer_list[1]))
    rule_dict = json.load(open(os.path.expanduser(args.rule)))
    context_list = [json.loads(line) for line in open(args.context)]
    image_to_context = {c["image"]: c for c in context_list}

    review_file = open(args.output, "w")
    idx = 0
    for ques_js, ans1_js, ans2_js in zip(f_q, f_ans1, f_ans2):
        ques = json.loads(ques_js)
        ans1 = json.loads(ans1_js)
        ans2 = json.loads(ans2_js)

        inst = image_to_context[ques["image"]]
        cap_str = "\n".join(inst["captions"]) if "captions" in inst else ""
        box_str = "\n".join(
            [f"{b['label']}: {b['bbox']}" for b in inst.get("boxes", [])]
        )

        category = "llava_bench_" + json.loads(ques_js).get("category", "conv")
        rule = rule_dict.get(category, rule_dict.get("default"))
        prompt = rule["prompt"]
        role = rule["role"]
        content = (f"[Context]\n{cap_str}\n\n{box_str}\n\n"
                   f"[Question]\n{ques['text']}\n\n"
                   f"[{role} 1]\n{ans1['text']}\n\n[End of {role} 1]\n\n"
                   f"[{role} 2]\n{ans2['text']}\n\n[End of {role} 2]\n\n"
                   f"[System]\n{prompt}\n\n")
        review = get_eval(content, args.max_tokens)
        scores = parse_score(review)
        review_file.write(json.dumps({
            "id": idx + 1,
            "question_id": ques["question_id"],
            "answer1_id": ans1.get("answer_id", ""),
            "answer2_id": ans2.get("answer_id", ""),
            "category": category,
            "content": review,
            "tuple": scores,
        }) + "\n")
        review_file.flush()
        idx += 1
    review_file.close()


if __name__ == "__main__":
    main()
