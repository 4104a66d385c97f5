"""Segment-anything worker (ref serve/sam_worker.py).

Registered name: ``sam``. Input: image + (boxes XOR points+point_labels).
Output: masks_rle (COCO RLE), boxes.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/sam_worker.py``.
"""

import numpy as np

from llava_plus_torch.serve.annotation import mask_to_rle
from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


class SamWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.predictor = None

    def load_model(self):
        if self.predictor is None:
            from segment_anything import SamPredictor, sam_model_registry

            sam = sam_model_registry[self.args.model_type](
                checkpoint=self.args.checkpoint_path
            )
            self.predictor = SamPredictor(sam)
        return self.predictor

    def generate(self, params):
        import torch

        predictor = self.load_model()
        image = np.asarray(load_image(params["image"]))
        boxes = params.get("boxes")
        points = params.get("points")
        point_labels = params.get("point_labels")
        if (boxes is None) == (points is None):
            raise ValueError("provide exactly one of boxes / points")
        predictor.set_image(image)
        if boxes is not None:
            box_t = torch.tensor(boxes, dtype=torch.float32)
            tb = predictor.transform.apply_boxes_torch(box_t, image.shape[:2])
            masks, _, _ = predictor.predict_torch(
                point_coords=None, point_labels=None, boxes=tb,
                multimask_output=False,
            )
            masks = masks[:, 0].cpu().numpy()
            out_boxes = boxes
        else:
            masks, _, _ = predictor.predict(
                point_coords=np.asarray(points),
                point_labels=np.asarray(point_labels),
                multimask_output=False,
            )
            out_boxes = None
        masks_rle = [mask_to_rle(m.astype(np.uint8)) for m in masks]
        out = {"masks_rle": masks_rle}
        if out_boxes is not None:
            out["boxes"] = out_boxes
        return out


def _extra(parser):
    parser.add_argument("--model-type", type=str, default="vit_h")
    parser.add_argument("--checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(SamWorker, 21031, ["sam"], _extra)
