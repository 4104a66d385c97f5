"""GroundingDINO -> SAM chained worker (ref serve/grounded_sam_worker.py).

Registered names: ``grounding_dino+sam``, ``grounded_sam``. Output combines
detection (boxes/logits/phrases/size) with segmentation (masks_rle).

The port's own copy of ``llava_plus_tpu/serve/tool_workers/grounded_sam_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import ToolWorker, tool_worker_main
from llava_plus_torch.serve.tool_workers.grounding_dino_worker import (
    GroundingDinoWorker,
)
from llava_plus_torch.serve.tool_workers.sam_worker import SamWorker


class GroundedSamWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.dino = GroundingDinoWorker(
            "", worker_addr, ["_internal"], no_register=True, args=args
        )
        self.sam = SamWorker(
            "", worker_addr, ["_internal"], no_register=True, args=args
        )

    def generate(self, params):
        det = self.dino.generate(params)
        seg = self.sam.generate({
            "image": params["image"], "boxes": det["boxes"],
        })
        return {**det, "masks_rle": seg["masks_rle"]}


def _extra(parser):
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--checkpoint-path", type=str, default="")
    parser.add_argument("--model-type", type=str, default="vit_h")
    parser.add_argument("--sam-checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(
        GroundedSamWorker, 21032, ["grounding_dino+sam", "grounded_sam"], _extra
    )
