"""Generate grounding tool-instruction training data.

The reference ships a launcher script (``playground/llava-plus-data/grounding/run.sh``)
whose generator script is absent from the repo; this module implements the
intended pipeline: from box-annotated images, emit conversations in the
thoughts🤔/actions🚀/value👉 grammar (serialized by
``mm_utils.reorganize_source_for_tool_use``) that teach the model to call
``grounding_dino`` and then summarize its output.

Input rows (JSON list):
    {"id": ..., "image": ..., "boxes": [{"label": str, "bbox": [x0,y0,x1,y1]}]}
Output rows: LLaVA training samples {"id", "image", "conversations"} where
the assistant turns carry structured {thoughts, actions, value} fields.

The port's own copy of ``llava_plus_tpu/tools/generate_grounding_data.py``.
"""

import argparse
import json
import random

QUESTION_TEMPLATES = [
    "Where is the {label} in this image?",
    "Can you locate the {label}?",
    "Find the {label} in the picture.",
    "Show me where the {label} is.",
    "What is the exact position of the {label}?",
]

THOUGHT_TEMPLATES = [
    "The user wants the location of an object; grounding_dino can detect it.",
    "To answer precisely I should run the grounding model on the image.",
    "This needs object localization, so I will call grounding_dino.",
]

SUMMARY_TEMPLATES = [
    "The {label} is at the bounding box {bbox} (normalized xyxy).",
    "I found the {label}: it spans {bbox} in normalized coordinates.",
    "The {label} is located at {bbox}.",
]


def make_sample(row, rng: random.Random):
    box = rng.choice(row["boxes"])
    label = box["label"]
    bbox = [round(float(v), 2) for v in box["bbox"]]
    question = rng.choice(QUESTION_TEMPLATES).format(label=label)
    # Two-round tool-use conversation mirroring the serving orchestrator
    # (gradio_web_server_llava_plus.py:489-659): ask -> call tool ->
    # tool output appended -> summarize.
    return {
        "id": row.get("id"),
        "image": row["image"],
        "conversations": [
            {"from": "human", "value": f"<image>\n{question}"},
            {
                "from": "gpt",
                "thoughts": rng.choice(THOUGHT_TEMPLATES),
                "actions": [{
                    "API_name": "grounding_dino",
                    "API_params": {"caption": label},
                }],
                "value": f"I will use grounding_dino to locate the {label}.",
            },
            {
                "from": "human",
                "value": (
                    "grounding_dino model outputs: {'boxes': "
                    + json.dumps([bbox])
                    + ", 'phrases': " + json.dumps([label])
                    + "}\n\nPlease summarize the model outputs and answer my "
                    "first question: " + question
                ),
            },
            {
                "from": "gpt",
                "thoughts": "The grounding model returned one confident box; "
                            "I can answer directly.",
                "actions": [],
                "value": rng.choice(SUMMARY_TEMPLATES).format(
                    label=label, bbox=bbox
                ),
            },
        ],
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--question-file", required=True,
                        help="JSON list of box-annotated images")
    parser.add_argument("--output-file", required=True)
    parser.add_argument("--num-samples", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    rows = json.load(open(args.question_file))
    rows = [r for r in rows if r.get("boxes")]
    if not rows:
        raise SystemExit(
            "error: no input rows have 'boxes' annotations; nothing to generate"
        )
    rng = random.Random(args.seed)
    samples = [
        make_sample(rng.choice(rows), rng) for _ in range(args.num_samples)
    ]
    with open(args.output_file, "w") as f:
        json.dump(samples, f, indent=1)
    print(f"wrote {len(samples)} samples -> {args.output_file}")


if __name__ == "__main__":
    main()
