"""Streaming smoke-test client (ref llava/serve/test_message.py): resolve a
worker through the controller, send a canned prompt, print the stream.

The port's own copy of ``llava_plus_tpu/serve/test_message.py``.
"""

import argparse
import json

import requests

from llava_plus_torch.conversation import default_conversation


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--worker-address", type=str)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--message", type=str,
                        default="Tell me a story with more than 1000 words.")
    args = parser.parse_args()

    if args.worker_address:
        worker_addr = args.worker_address
    else:
        ret = requests.post(args.controller_address + "/refresh_all_workers")
        ret = requests.post(args.controller_address + "/list_models")
        models = ret.json()["models"]
        models.sort()
        print(f"Models: {models}")
        model_name = args.model_name or (models[0] if models else None)
        ret = requests.post(
            args.controller_address + "/get_worker_address",
            json={"model": model_name},
        )
        worker_addr = ret.json()["address"]
        print(f"worker_addr: {worker_addr}")

    if worker_addr == "":
        return

    conv = default_conversation.copy()
    conv.append_message(conv.roles[0], args.message)
    prompt = conv.get_prompt()

    headers = {"User-Agent": "LLaVA-Plus-TPU Client"}
    pload = {
        "model": args.model_name,
        "prompt": prompt,
        "max_new_tokens": args.max_new_tokens,
        "temperature": 0.7,
        "stop": conv.sep,
    }
    response = requests.post(
        worker_addr + "/worker_generate_stream",
        headers=headers, json=pload, stream=True,
    )

    print(prompt.replace(conv.sep, "\n"), end="")
    for chunk in response.iter_lines(
        chunk_size=8192, decode_unicode=False, delimiter=b"\0"
    ):
        if chunk:
            data = json.loads(chunk.decode())
            output = data["text"].split(conv.sep)[-1]
            print(output, end="\r")
    print("")


if __name__ == "__main__":
    main()
