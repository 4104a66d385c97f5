"""Semantic-SAM multi-granularity segmentation (ref serve/semantic_sam_worker.py).

Registered name: ``semantic-sam``. Input: image, point. Output:
iou_sort_masks (list of b64 PNG visualizations, IoU-sorted).

The port's own copy of ``llava_plus_tpu/serve/tool_workers/semantic_sam_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


class SemanticSamWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.model = None

    def load_model(self):
        if self.model is None:
            from semantic_sam import build_semantic_sam

            self.model = build_semantic_sam(
                model_type=self.args.model_type,
                ckpt=self.args.checkpoint_path,
            )
        return self.model

    def generate(self, params):
        model = self.load_model()
        image = load_image(params["image"])
        point = params.get("point")
        from semantic_sam import prepare_image, SemanticSamPredictor

        from llava_plus_torch.serve.tool_workers.base import image_to_b64

        original_image, input_image = prepare_image(image_pth=None, image=image)
        predictor = SemanticSamPredictor(model)
        masks = predictor.predict_masks(original_image, input_image, point=point)
        ious = predictor.ious if hasattr(predictor, "ious") else range(len(masks))
        order = sorted(range(len(masks)), key=lambda i: -float(ious[i]))
        from llava_plus_torch.serve.annotation import draw_masks

        vis = [image_to_b64(draw_masks(image, [masks[i]])) for i in order]
        return {"iou_sort_masks": vis}


def _extra(parser):
    parser.add_argument("--model-type", type=str, default="L")
    parser.add_argument("--checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(SemanticSamWorker, 21043, ["semantic-sam"], _extra)
