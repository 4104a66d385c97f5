"""ScienceQA -> LLaVA conversation format (the port's copy of scripts/convert_sqa_to_llava.py)."""

import argparse
import json
import os

from convert_sqa_to_llava_base_prompt import build_prompt_chatbot


def convert_to_llava(base_dir, split, prompt_format="QCM-LEA"):
    split_indices = json.load(
        open(os.path.join(base_dir, "pid_splits.json"))
    )[split]
    problems = json.load(open(os.path.join(base_dir, "problems.json")))

    split_problems = build_prompt_chatbot(
        problems, split_indices, prompt_format,
        use_caption=False, is_test=False,
    )

    target_format = []
    for prob_id, (input_text, output) in split_problems.items():
        if input_text.startswith("Hint: "):
            input_text = input_text.replace("Hint: ", "Context: ", 1)

        raw_prob_data = problems[prob_id]
        if raw_prob_data["image"] is None:
            target_format.append({
                "id": prob_id,
                "conversations": [
                    {"from": "human", "value": f"{input_text}"},
                    {"from": "gpt", "value": f"{output}"},
                ],
            })
        else:
            target_format.append({
                "id": prob_id,
                "image": os.path.join(prob_id, raw_prob_data["image"]),
                "conversations": [
                    {"from": "human", "value": f"{input_text}\n<image>"},
                    {"from": "gpt", "value": f"{output}"},
                ],
            })

    print(f"Number of samples: {len(target_format)}")
    out = os.path.join(base_dir, f"llava_{split}_{prompt_format}.json")
    with open(out, "w") as f:
        json.dump(target_format, f, indent=2)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str, required=True)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--prompt-format", type=str, default="QCM-LEA")
    args = parser.parse_args()
    convert_to_llava(args.base_dir, args.split, args.prompt_format)
