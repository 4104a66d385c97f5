"""Open-set detection worker (ref serve/grounding_dino_worker.py).

Registered name: ``grounding_dino``. Input: caption, image, box_threshold,
text_threshold. Output: boxes (xyxy, 2dp), logits, phrases, size — after NMS
at IoU 0.8. Requires the external GroundingDINO package + weights.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/grounding_dino_worker.py``.
"""

import numpy as np

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


def nms_xyxy(boxes, scores, iou_threshold=0.8):
    """Plain numpy NMS (replaces torchvision.ops.nms)."""
    boxes = np.asarray(boxes, dtype=np.float32)
    scores = np.asarray(scores, dtype=np.float32)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx1 - xx0, 0, None) * np.clip(yy1 - yy0, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return keep


class GroundingDinoWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.model = None

    def load_model(self):
        if self.model is None:
            from groundingdino.util.inference import load_model  # external

            self.model = load_model(
                self.args.config_file, self.args.checkpoint_path
            )
        return self.model

    def generate(self, params):
        from groundingdino.util.inference import predict
        import groundingdino.datasets.transforms as T
        import torch

        model = self.load_model()
        image_pil = load_image(params["image"])
        caption = params["caption"]
        transform = T.Compose([
            T.RandomResize([800], max_size=1333),
            T.ToTensor(),
            T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
        ])
        image, _ = transform(image_pil, None)
        boxes, logits, phrases = predict(
            model=model, image=image, caption=caption,
            box_threshold=float(params.get("box_threshold", 0.3)),
            text_threshold=float(params.get("text_threshold", 0.25)),
        )
        W, H = image_pil.size
        # cxcywh-normalized -> xyxy pixels
        b = boxes.numpy()
        xyxy = np.stack([
            (b[:, 0] - b[:, 2] / 2) * W, (b[:, 1] - b[:, 3] / 2) * H,
            (b[:, 0] + b[:, 2] / 2) * W, (b[:, 1] + b[:, 3] / 2) * H,
        ], axis=1)
        keep = nms_xyxy(xyxy, logits.numpy(), 0.8)
        return {
            "boxes": [[round(float(v), 2) for v in xyxy[i]] for i in keep],
            "logits": [round(float(logits[i]), 4) for i in keep],
            "phrases": [phrases[i] for i in keep],
            "size": [H, W],
        }


def _extra(parser):
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(GroundingDinoWorker, 21030, ["grounding_dino"], _extra)
