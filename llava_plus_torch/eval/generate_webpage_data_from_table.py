"""Generate the static-results-webpage JSON from eval table fixtures (ref
llava/eval/generate_webpage_data_from_table.py). Reads table/question.jsonl,
per-model answers in table/answer/, and pairwise reviews in table/review/,
and writes webpage/data.json consumed by webpage/index.html.

The port's own copy of ``llava_plus_tpu/eval/generate_webpage_data_from_table.py``.
"""

import argparse
import json
import os


def read_jsonl(path, key=None):
    data = []
    with open(os.path.expanduser(path)) as f:
        for line in f:
            if line.strip():
                data.append(json.loads(line))
    if key is not None:
        data.sort(key=lambda x: x[key])
        data = {item[key]: item for item in data}
    return data


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--table-dir", default=os.path.join(
        os.path.dirname(__file__), "table"))
    parser.add_argument("--output", default=os.path.join(
        os.path.dirname(__file__), "webpage", "data.json"))
    parser.add_argument("--baseline", default="vicuna-13b",
                        help="answer file suffix used as Assistant 1")
    parser.add_argument("--models", nargs="+", default=None,
                        help="model names (answer_<m>.jsonl in table/answer)")
    args = parser.parse_args()

    table = args.table_dir
    questions = read_jsonl(
        os.path.join(table, "question.jsonl"), key="question_id")

    answer_dir = os.path.join(table, "answer")
    models = args.models
    if models is None:
        models = sorted(
            f[len("answer_"):-len(".jsonl")]
            for f in os.listdir(answer_dir)
            if f.startswith("answer_") and f.endswith(".jsonl")
        )

    records = []
    for qid, q in questions.items():
        row = {"question_id": qid, "category": q.get("category", ""),
               "question": q["text"], "answers": {}, "scores": {},
               "evaluations": {}}
        records.append(row)

    by_qid = {r["question_id"]: r for r in records}
    for model in models:
        answers = read_jsonl(
            os.path.join(answer_dir, f"answer_{model}.jsonl"),
            key="question_id")
        for qid, ans in answers.items():
            if qid in by_qid:
                by_qid[qid]["answers"][model] = ans["text"]

    review_dir = os.path.join(table, "review")
    if os.path.isdir(review_dir):
        for f in os.listdir(review_dir):
            if not f.endswith(".jsonl"):
                continue
            pair = f[len("review_"):-len(".jsonl")]
            for rev in read_jsonl(os.path.join(review_dir, f)):
                row = by_qid.get(rev["question_id"])
                if row is None:
                    continue
                if "tuple" in rev:
                    row["scores"][pair] = rev["tuple"]
                commentary = rev.get("content") or rev.get("text")
                if commentary:
                    row["evaluations"][pair] = commentary

    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump({"models": models, "records": records}, f, indent=1)
    print(f"wrote {len(records)} records for {len(models)} models -> {args.output}")


if __name__ == "__main__":
    main()
