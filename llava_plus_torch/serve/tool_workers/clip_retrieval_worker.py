"""CLIP retrieval worker over a LAION index (ref serve/clip_retrieval_worker.py).

Registered names: ``retrieval``, ``clip``. Input: image and/or text. Output:
retrieval_results [{caption, similarity}], size.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/clip_retrieval_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, load_image, tool_worker_main,
)


class ClipRetrievalWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.client = None

    def load_model(self):
        if self.client is None:
            from clip_retrieval.clip_client import ClipClient, Modality

            self.client = ClipClient(
                url=self.args.backend_url,
                indice_name=self.args.index_name,
                modality=Modality.IMAGE,
                num_images=int(self.args.num_results),
            )
        return self.client

    def generate(self, params):
        client = self.load_model()
        size = None
        if params.get("image"):
            pil = load_image(params["image"])
            W, H = pil.size
            size = [H, W]
            results = client.query(image=params["image"])
        else:
            results = client.query(text=params["text"])
        out = {
            "retrieval_results": [
                {"caption": r.get("caption", ""),
                 "similarity": float(r.get("similarity", 0.0))}
                for r in results
            ]
        }
        if size:
            out["size"] = size
        return out


def _extra(parser):
    parser.add_argument("--backend-url", type=str,
                        default="https://knn.laion.ai/knn-service")
    parser.add_argument("--index-name", type=str, default="laion5B-L-14")
    parser.add_argument("--num-results", type=int, default=10)


if __name__ == "__main__":
    tool_worker_main(ClipRetrievalWorker, 21037, ["retrieval", "clip"], _extra)
