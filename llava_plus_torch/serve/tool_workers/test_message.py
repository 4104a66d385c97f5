"""Generic tool-worker smoke client (replaces the reference's 14 per-tool
``*_test_message.py`` scripts with one parameterized client): resolve the
tool through the controller (or --worker-address), send a canned request
with a real image (resized to 800 px, b64), print the JSON and latency.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/test_message.py``.
"""

import argparse
import base64
import json
import time
from io import BytesIO

import requests
from PIL import Image

CANNED_PARAMS = {
    "grounding_dino": {"caption": "a cat"},
    "sam": {"boxes": [[10, 10, 50, 50]]},
    "grounded_sam": {"caption": "a cat"},
    "grounding_dino+sam": {"caption": "a cat"},
    "ram": {},
    "ram+grounding_dino": {},
    "blip2": {},
    "blip2+grounding_dino": {},
    "retrieval": {},
    "clip": {},
    "ocr": {},
    "easyocr": {},
    "stable-diffusion": {"prompt": "a serene lake at sunset"},
    "sd": {"prompt": "a serene lake at sunset"},
    "instruct-pix2pix": {"instruction": "make it snowy"},
    "ip2p": {"instruction": "make it snowy"},
    "inpainting": {"prompt": "a red ball"},
    "seem": {},
    "semantic-sam": {"point": [0.5, 0.5]},
    "controlnet": {"mode": "openseed"},
}


def encode_image(path: str) -> str:
    img = Image.open(path).convert("RGB")
    if max(img.size) > 800:
        scale = 800 / max(img.size)
        img = img.resize((int(img.width * scale), int(img.height * scale)))
    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--worker-address", type=str, default=None)
    parser.add_argument("--tool", type=str, required=True,
                        choices=sorted(CANNED_PARAMS))
    parser.add_argument("--image", type=str, default=None,
                        help="image file to send; default: a deterministic "
                             "generated demo scene (no external files "
                             "needed — utils/demo_assets.py)")
    parser.add_argument("--no-image", action="store_true",
                        help="send no image at all")
    args = parser.parse_args()

    worker_addr = args.worker_address
    if worker_addr is None:
        ret = requests.post(
            args.controller_address + "/get_worker_address",
            json={"model": args.tool},
        )
        worker_addr = ret.json()["address"]
        print(f"worker_addr: {worker_addr}")
    if not worker_addr:
        print("no worker available")
        return

    payload = dict(CANNED_PARAMS[args.tool])
    if args.image:
        payload["image"] = encode_image(args.image)
    elif not args.no_image:
        from llava_plus_torch.utils.demo_assets import demo_image_b64

        payload["image"] = demo_image_b64("cat")

    tic = time.time()
    resp = requests.post(
        worker_addr + "/worker_generate", json=payload, timeout=300
    )
    toc = time.time()
    out = resp.json()
    # avoid dumping huge base64 blobs to the console
    shown = {
        k: (v[:64] + "..." if isinstance(v, str) and len(v) > 80 else v)
        for k, v in out.items()
    }
    print(json.dumps(shown, indent=2, ensure_ascii=False))
    print(f"latency: {toc - tic:.3f}s")


if __name__ == "__main__":
    main()
