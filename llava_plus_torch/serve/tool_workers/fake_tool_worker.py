"""Fake tool worker: canned schema-correct outputs for every tool API.

The test seam the reference lacks (SURVEY.md §4): the full controller ->
orchestrator -> tool round-trip runs with no GPU models. Outputs follow each
tool's documented schema (SURVEY.md §2.6 inventory).

The port's own copy of ``llava_plus_tpu/serve/tool_workers/fake_tool_worker.py``.
"""

import numpy as np

from llava_plus_torch.serve.annotation import mask_to_rle
from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, image_to_b64, load_image, tool_worker_main,
)


def _canned(api_name, image):
    W, H = (image.size if image is not None else (64, 64))
    box = [round(W * 0.25, 2), round(H * 0.25, 2),
           round(W * 0.75, 2), round(H * 0.75, 2)]
    mask = np.zeros((H, W), np.uint8)
    mask[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 1
    if api_name == "grounding_dino":
        return {"boxes": [box], "logits": [0.92], "phrases": ["object"],
                "size": [H, W]}
    if api_name == "sam":
        return {"masks_rle": [mask_to_rle(mask)], "boxes": [box]}
    if api_name in ("grounding_dino+sam", "grounded_sam"):
        return {"boxes": [box], "logits": [0.92], "phrases": ["object"],
                "size": [H, W], "masks_rle": [mask_to_rle(mask)]}
    if api_name == "ram":
        return {"tags": "cat | sofa", "tags_chinese": "猫 | 沙发",
                "size": [H, W]}
    if api_name == "ram+grounding_dino":
        return {"tags": "cat | sofa", "tags_chinese": "猫 | 沙发",
                "boxes": [box], "logits": [0.9], "phrases": ["cat"],
                "size": [H, W]}
    if api_name == "blip2":
        return {"caption": "a photo of a cat on a sofa", "size": [H, W]}
    if api_name == "blip2+grounding_dino":
        return {"caption": "a photo of a cat on a sofa", "boxes": [box],
                "logits": [0.9], "phrases": ["cat"], "size": [H, W]}
    if api_name in ("retrieval", "clip"):
        return {"retrieval_results": [
            {"caption": "a similar cat", "similarity": 0.87},
            {"caption": "another cat", "similarity": 0.81},
        ], "size": [H, W]}
    if api_name in ("ocr", "easyocr"):
        return {"boxes": [[[0, 0], [W, 0], [W, 20], [0, 20]]],
                "texts": ["HELLO"], "scores": [0.99]}
    if api_name in ("stable-diffusion", "sd", "instruct-pix2pix", "ip2p",
                    "inpainting", "seem"):
        from PIL import Image

        img = image or Image.new("RGB", (W, H), (127, 127, 127))
        return {"edited_image": image_to_b64(img)}
    if api_name == "semantic-sam":
        from PIL import Image

        img = image or Image.new("RGB", (W, H), (127, 127, 127))
        return {"iou_sort_masks": [image_to_b64(img)]}
    if api_name == "controlnet":
        from PIL import Image

        img = image or Image.new("RGB", (W, H), (127, 127, 127))
        return {"image_seg": image_to_b64(img)}
    raise ValueError(f"unknown tool api: {api_name}")


class FakeToolWorker(ToolWorker):
    """Serves canned outputs; the registered model name decides the schema."""

    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)

    def generate(self, params):
        image = load_image(params.get("image"))
        api_name = params.get("_api_name", self.model_names[0])
        if api_name == "controlnet" and params.get("mode") == "controlnet":
            from PIL import Image

            img = image or Image.new("RGB", (64, 64))
            return {"edited_image": image_to_b64(img)}
        return _canned(api_name, image)


if __name__ == "__main__":
    tool_worker_main(FakeToolWorker, 21050, ["grounding_dino"])
