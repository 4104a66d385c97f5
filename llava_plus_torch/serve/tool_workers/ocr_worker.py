"""OCR worker (easyocr; ref serve/ocr_worker.py).

Registered names: ``ocr``, ``easyocr``. Input: image. Output: boxes, texts,
scores.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/ocr_worker.py``.
"""

import numpy as np

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


class OcrWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.reader = None

    def load_model(self):
        if self.reader is None:
            import easyocr

            langs = (self.args.languages or "en").split(",")
            self.reader = easyocr.Reader(langs)
        return self.reader

    def generate(self, params):
        reader = self.load_model()
        image = np.asarray(load_image(params["image"]))
        results = reader.readtext(image)
        boxes, texts, scores = [], [], []
        for box, text, score in results:
            boxes.append([[float(x), float(y)] for x, y in box])
            texts.append(text)
            scores.append(round(float(score), 4))
        return {"boxes": boxes, "texts": texts, "scores": scores}


def _extra(parser):
    parser.add_argument("--languages", type=str, default="en")


if __name__ == "__main__":
    tool_worker_main(OcrWorker, 21038, ["ocr", "easyocr"], _extra)
