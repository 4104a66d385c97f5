"""Text-to-image worker (diffusers SD; ref serve/stablediffusion_worker.py).

Registered names: ``stable-diffusion``, ``sd``. Input: prompt. Output:
edited_image (b64 PNG).

The port's own copy of ``llava_plus_tpu/serve/tool_workers/stablediffusion_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, image_to_b64, tool_worker_main,
)


class StableDiffusionWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.pipe = None

    def load_model(self):
        if self.pipe is None:
            from diffusers import StableDiffusionPipeline

            self.pipe = StableDiffusionPipeline.from_pretrained(
                self.args.model_path or "runwayml/stable-diffusion-v1-5"
            )
        return self.pipe

    def generate(self, params):
        pipe = self.load_model()
        image = pipe(
            params["prompt"],
            num_inference_steps=int(params.get("num_inference_steps", 50)),
        ).images[0]
        return {"edited_image": image_to_b64(image)}


def _extra(parser):
    parser.add_argument("--model-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(
        StableDiffusionWorker, 21039, ["stable-diffusion", "sd"], _extra
    )
