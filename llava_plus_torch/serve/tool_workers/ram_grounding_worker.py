"""RAM tags -> GroundingDINO chained worker (ref serve/ram_grounding_worker.py).

Registered name: ``ram+grounding_dino``. Input: image. Output: tags + boxes/
logits/phrases.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/ram_grounding_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import ToolWorker, tool_worker_main
from llava_plus_torch.serve.tool_workers.grounding_dino_worker import (
    GroundingDinoWorker,
)
from llava_plus_torch.serve.tool_workers.ram_worker import RamWorker


class RamGroundingWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.ram = RamWorker("", worker_addr, ["_internal"],
                             no_register=True, args=args)
        self.dino = GroundingDinoWorker("", worker_addr, ["_internal"],
                                        no_register=True, args=args)

    def generate(self, params):
        tags = self.ram.generate(params)
        caption = tags["tags"].replace(" |", ",") if isinstance(
            tags["tags"], str) else ", ".join(tags["tags"])
        det = self.dino.generate({**params, "caption": caption})
        return {**tags, **det}


def _extra(parser):
    parser.add_argument("--checkpoint-path", type=str, default="")
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--dino-checkpoint-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(RamGroundingWorker, 21034, ["ram+grounding_dino"], _extra)
