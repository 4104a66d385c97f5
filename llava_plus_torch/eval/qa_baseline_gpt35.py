"""GPT-3.5 baseline answer generation (ref llava/eval/qa_baseline_gpt35.py).
Network-gated: requires OPENAI_API_KEY.

The port's own copy of ``llava_plus_tpu/eval/qa_baseline_gpt35.py``.
"""

import argparse
import json
import os
import time

MODEL_ID = "gpt-3.5-turbo:20230327"


def get_answer(question_id, question, max_tokens):
    import openai

    ans = {"answer_id": os.urandom(11).hex(), "model_id": MODEL_ID,
           "question_id": question_id}
    for _ in range(3):
        try:
            response = openai.chat.completions.create(
                model="gpt-3.5-turbo",
                messages=[
                    {"role": "system", "content": "You are a helpful assistant."},
                    {"role": "user", "content": question},
                ],
                max_tokens=max_tokens,
            )
            ans["text"] = response.choices[0].message.content
            return ans
        except Exception as e:
            print("[ERROR]", e)
            ans["text"] = "#ERROR#"
            time.sleep(1)
    return ans


def main():
    parser = argparse.ArgumentParser(description="ChatGPT answer generation.")
    parser.add_argument("-q", "--question")
    parser.add_argument("-o", "--output")
    parser.add_argument("--max-tokens", type=int, default=1024)
    args = parser.parse_args()

    questions = [json.loads(l) for l in open(args.question)]
    with open(args.output, "w") as f:
        for q in questions:
            ans = get_answer(q["question_id"], q["text"], args.max_tokens)
            f.write(json.dumps(ans) + "\n")


if __name__ == "__main__":
    main()
