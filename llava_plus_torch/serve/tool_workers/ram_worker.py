"""Image-tagging worker (RAM/Tag2Text; ref serve/ram_worker.py).

Registered name: ``ram``. Input: image. Output: tags, tags_chinese, size.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/ram_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


class RamWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.model = None

    def load_model(self):
        if self.model is None:
            from ram import get_transform
            from ram.models import ram

            self.model = ram(
                pretrained=self.args.checkpoint_path,
                image_size=384, vit="swin_l",
            ).eval()
            self.transform = get_transform(image_size=384)
        return self.model

    def generate(self, params):
        from ram import inference_ram
        import torch

        model = self.load_model()
        pil = load_image(params["image"])
        W, H = pil.size
        with torch.no_grad():
            tags, tags_chinese = inference_ram(
                self.transform(pil).unsqueeze(0), model
            )
        return {"tags": tags, "tags_chinese": tags_chinese, "size": [H, W]}


def _extra(parser):
    parser.add_argument("--checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(RamWorker, 21033, ["ram"], _extra)
