"""Captioning worker (HF BLIP-2; ref serve/blip2_worker.py).

Registered name: ``blip2``. Input: image. Output: caption, size.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/blip2_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


class Blip2Worker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.model = None

    def load_model(self):
        if self.model is None:
            from transformers import Blip2ForConditionalGeneration, Blip2Processor

            name = self.args.model_path or "Salesforce/blip2-opt-2.7b"
            self.processor = Blip2Processor.from_pretrained(name)
            self.model = Blip2ForConditionalGeneration.from_pretrained(name)
        return self.model

    def generate(self, params):
        import torch

        model = self.load_model()
        pil = load_image(params["image"])
        W, H = pil.size
        inputs = self.processor(images=pil, return_tensors="pt")
        with torch.no_grad():
            out = model.generate(**inputs, max_new_tokens=64)
        caption = self.processor.batch_decode(out, skip_special_tokens=True)[0]
        return {"caption": caption.strip(), "size": [H, W]}


def _extra(parser):
    parser.add_argument("--model-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(Blip2Worker, 21035, ["blip2"], _extra)
