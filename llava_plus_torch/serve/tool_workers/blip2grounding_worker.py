"""BLIP-2 caption -> GroundingDINO chained worker
(ref serve/blip2grounding_worker.py). Registered name:
``blip2+grounding_dino``.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/blip2grounding_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import ToolWorker, tool_worker_main
from llava_plus_torch.serve.tool_workers.blip2_worker import Blip2Worker
from llava_plus_torch.serve.tool_workers.grounding_dino_worker import (
    GroundingDinoWorker,
)


class Blip2GroundingWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.blip2 = Blip2Worker("", worker_addr, ["_internal"],
                                 no_register=True, args=args)
        self.dino = GroundingDinoWorker("", worker_addr, ["_internal"],
                                        no_register=True, args=args)

    def generate(self, params):
        cap = self.blip2.generate(params)
        det = self.dino.generate({**params, "caption": cap["caption"]})
        return {**cap, **det}


def _extra(parser):
    parser.add_argument("--model-path", type=str, default="")
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(Blip2GroundingWorker, 21036, ["blip2+grounding_dino"], _extra)
