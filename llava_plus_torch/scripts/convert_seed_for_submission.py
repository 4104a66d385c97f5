"""SEED-Bench answers -> submission + category accuracies
(the port's copy of scripts/convert_seed_for_submission.py)."""

import argparse
import json


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str, required=True)
    parser.add_argument("--result-file", type=str, required=True)
    parser.add_argument("--result-upload-file", type=str, required=True)
    return parser.parse_args()


def eval_single(annotation, results):
    question_type_counts = {}
    for qid, (pred, q) in results.items():
        q_type = q["question_type_id"]
        stats = question_type_counts.setdefault(q_type, [0, 0])
        stats[1] += 1
        if pred == q["answer"]:
            stats[0] += 1
    total_correct = sum(v[0] for v in question_type_counts.values())
    total = sum(v[1] for v in question_type_counts.values())
    print(f"Total accuracy: {100. * total_correct / total:.2f}%" if total else "no rows")
    for q_type, (c, n) in sorted(question_type_counts.items()):
        print(f"type {q_type}: {100. * c / n:.2f}% ({c}/{n})")


if __name__ == "__main__":
    args = get_args()
    annotations = json.load(open(args.annotation_file))["questions"]
    annotations = {str(q["question_id"]): q for q in annotations}

    results = {}
    upload = []
    for line in open(args.result_file):
        row = json.loads(line)
        qid = str(row["question_id"])
        pred = row["text"].strip().rstrip(".").upper()[:1]
        if qid in annotations:
            results[qid] = (pred, annotations[qid])
            upload.append({"question_id": qid, "prediction": pred})
    eval_single(annotations, results)
    with open(args.result_upload_file, "w") as f:
        for row in upload:
            f.write(json.dumps(row) + "\n")
