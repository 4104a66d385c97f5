"""SEEM referring-segmentation worker (ref serve/seem_worker.py).

Registered name: ``seem``. Input: image, refimg, refmask. Output:
edited_image (segmentation visualization).

The port's own copy of ``llava_plus_tpu/serve/tool_workers/seem_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, image_to_b64, load_image, tool_worker_main,
)


class SeemWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.model = None

    def load_model(self):
        if self.model is None:
            # External: https://github.com/UX-Decoder/Segment-Everything-Everywhere-All-At-Once
            from seem.modeling.BaseModel import BaseModel
            from seem.modeling import build_model
            from seem.utils.distributed import init_distributed
            from seem.utils.arguments import load_opt_from_config_files

            opt = load_opt_from_config_files([self.args.config_file])
            opt = init_distributed(opt)
            self.model = BaseModel(
                opt, build_model(opt)
            ).from_pretrained(self.args.checkpoint_path).eval()
        return self.model

    def generate(self, params):
        model = self.load_model()
        image = load_image(params["image"])
        refimg = load_image(params.get("refimg"))
        refmask = params.get("refmask")
        from seem.demo.seem.tasks import interactive_infer_image

        out_image, _ = interactive_infer_image(
            model, None, image, ["Example"],
            refimg=refimg, refmask=refmask,
        )
        return {"edited_image": image_to_b64(out_image)}


def _extra(parser):
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(SeemWorker, 21042, ["seem"], _extra)
