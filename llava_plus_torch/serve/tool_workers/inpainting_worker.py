"""Inpainting worker: DINO-located region + SD inpaint
(ref serve/inpainting_worker.py). Registered name: ``inpainting``.
Input: image, mask(_rle), prompt. Output: edited_image.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/inpainting_worker.py``.
"""

import numpy as np
from PIL import Image

from llava_plus_torch.serve.annotation import rle_to_mask
from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, image_to_b64, load_image, tool_worker_main,
)


class InpaintingWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.pipe = None

    def load_model(self):
        if self.pipe is None:
            from diffusers import StableDiffusionInpaintPipeline

            self.pipe = StableDiffusionInpaintPipeline.from_pretrained(
                self.args.model_path or "runwayml/stable-diffusion-inpainting"
            )
        return self.pipe

    def generate(self, params):
        pipe = self.load_model()
        image = load_image(params["image"])
        mask = params.get("mask")
        if mask is None:
            raise ValueError("inpainting requires a mask (COCO RLE)")
        mask_arr = rle_to_mask(mask) if isinstance(mask, dict) else np.asarray(mask)
        mask_img = Image.fromarray((mask_arr * 255).astype(np.uint8))
        out = pipe(
            prompt=params.get("prompt", ""),
            image=image.resize((512, 512)),
            mask_image=mask_img.resize((512, 512)),
        ).images[0].resize(image.size)
        return {"edited_image": image_to_b64(out)}


def _extra(parser):
    parser.add_argument("--model-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(InpaintingWorker, 21041, ["inpainting"], _extra)
