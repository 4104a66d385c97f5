"""Instruction-based image editing (ref serve/instructpix2pix_worker.py).

Registered names: ``instruct-pix2pix``, ``ip2p``. Input: image, instruction.
Output: edited_image.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/instructpix2pix_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, image_to_b64, load_image, tool_worker_main,
)


class InstructPix2PixWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.pipe = None

    def load_model(self):
        if self.pipe is None:
            from diffusers import StableDiffusionInstructPix2PixPipeline

            self.pipe = StableDiffusionInstructPix2PixPipeline.from_pretrained(
                self.args.model_path or "timbrooks/instruct-pix2pix"
            )
        return self.pipe

    def generate(self, params):
        pipe = self.load_model()
        image = load_image(params["image"])
        out = pipe(
            params.get("instruction") or params.get("prompt"),
            image=image,
            num_inference_steps=int(params.get("num_inference_steps", 20)),
        ).images[0]
        return {"edited_image": image_to_b64(out)}


def _extra(parser):
    parser.add_argument("--model-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(
        InstructPix2PixWorker, 21040, ["instruct-pix2pix", "ip2p"], _extra
    )
