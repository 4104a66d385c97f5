"""GPT-4 pairwise judge (ref llava/eval/eval_gpt_review.py): score two
model answers with a rubric; requires OPENAI_API_KEY (network-gated).

The port's own copy of ``llava_plus_tpu/eval/eval_gpt_review.py``.
"""

import argparse
import json
import os
import time

NUM_SECONDS_TO_SLEEP = 3


def get_eval(content: str, max_tokens: int, model: str = "gpt-4"):
    if os.environ.get("LLAVA_GPT_REVIEW_STUB"):
        # Offline mode: deterministic canned review so the full judge
        # pipeline (context build -> review -> score parse -> summarize)
        # can run and be tested with no API access. The score line matches
        # the format parse_score expects.
        return "5 4\nStub review (LLAVA_GPT_REVIEW_STUB set)."
    import openai

    while True:
        try:
            response = openai.chat.completions.create(
                model=model,
                messages=[
                    {"role": "system",
                     "content": "You are a helpful and precise assistant "
                                "for checking the quality of the answer."},
                    {"role": "user", "content": content},
                ],
                temperature=0.2,
                max_tokens=max_tokens,
            )
            break
        except Exception as e:
            print(e)
            time.sleep(NUM_SECONDS_TO_SLEEP)
    return response.choices[0].message.content


def parse_score(review: str):
    try:
        score_pair = review.split("\n")[0]
        score_pair = score_pair.replace(",", " ")
        sp = score_pair.split(" ")
        if len(sp) == 2:
            return [float(sp[0]), float(sp[1])]
        print("error", review)
        return [-1, -1]
    except Exception as e:
        print(e)
        print("error", review)
        return [-1, -1]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-q", "--question")
    parser.add_argument("-a", "--answer-list", nargs="+", default=[])
    parser.add_argument("-r", "--rule")
    parser.add_argument("-o", "--output")
    parser.add_argument("--max-tokens", type=int, default=1024)
    args = parser.parse_args()

    f_q = open(os.path.expanduser(args.question))
    f_ans1 = open(os.path.expanduser(args.answer_list[0]))
    f_ans2 = open(os.path.expanduser(args.answer_list[1]))
    rule_dict = json.load(open(os.path.expanduser(args.rule)))

    review_file = open(args.output, "w")
    idx = 0
    for ques_js, ans1_js, ans2_js in zip(f_q, f_ans1, f_ans2):
        ques = json.loads(ques_js)
        ans1 = json.loads(ans1_js)
        ans2 = json.loads(ans2_js)

        category = json.loads(ques_js).get("category", "general")
        rule = rule_dict.get(category, rule_dict.get("default"))
        prompt = rule["prompt"]
        role = rule["role"]
        content = (f"[Question]\n{ques['text']}\n\n"
                   f"[{role} 1]\n{ans1['text']}\n\n[End of {role} 1]\n\n"
                   f"[{role} 2]\n{ans2['text']}\n\n[End of {role} 2]\n\n"
                   f"[System]\n{prompt}\n\n")
        review = get_eval(content, args.max_tokens)
        scores = parse_score(review)
        review_file.write(json.dumps({
            "id": idx + 1,
            "question_id": ques["question_id"],
            "answer1_id": ans1["answer_id"],
            "answer2_id": ans2["answer_id"],
            "category": category,
            "content": review,
            "tuple": scores,
        }) + "\n")
        review_file.flush()
        idx += 1
    review_file.close()


if __name__ == "__main__":
    main()
