"""OpenSeeD segmentation + ControlNet conditional generation
(ref serve/openseed_controlnet_worker.py). Registered name: ``controlnet``
with modes ``openseed`` (-> image_seg) and ``controlnet`` (-> edited_image).

The port's own copy of ``llava_plus_tpu/serve/tool_workers/openseed_controlnet_worker.py``.
"""

from llava_plus_torch.serve.tool_workers.base import (
    ToolWorker, image_to_b64, load_image, tool_worker_main,
)


class OpenSeedControlNetWorker(ToolWorker):
    def __init__(self, controller_addr, worker_addr, model_names, *,
                 args=None, **kw):
        super().__init__(controller_addr, worker_addr, model_names, **kw)
        self.args = args
        self.openseed = None
        self.controlnet = None

    def load_openseed(self):
        if self.openseed is None:
            from openseed.BaseModel import BaseModel
            from openseed import build_model
            from openseed.utils.arguments import load_opt_from_config_files

            opt = load_opt_from_config_files([self.args.openseed_config])
            self.openseed = BaseModel(opt, build_model(opt)).from_pretrained(
                self.args.openseed_checkpoint
            ).eval()
        return self.openseed

    def load_controlnet(self):
        if self.controlnet is None:
            from diffusers import (
                ControlNetModel, StableDiffusionControlNetPipeline,
            )

            controlnet = ControlNetModel.from_pretrained(
                self.args.controlnet_path or "lllyasviel/sd-controlnet-seg"
            )
            self.controlnet = StableDiffusionControlNetPipeline.from_pretrained(
                self.args.sd_path or "runwayml/stable-diffusion-v1-5",
                controlnet=controlnet,
            )
        return self.controlnet

    def generate(self, params):
        mode = params.get("mode", "openseed")
        image = load_image(params["image"])
        if mode == "openseed":
            model = self.load_openseed()
            from openseed.demo.utils import semantic_inference

            seg_vis = semantic_inference(model, image)
            return {"image_seg": image_to_b64(seg_vis)}
        if mode == "controlnet":
            pipe = self.load_controlnet()
            seg = load_image(params.get("mask"))
            out = pipe(
                params.get("prompt", ""), image=seg,
                num_inference_steps=int(params.get("num_inference_steps", 20)),
            ).images[0]
            return {"edited_image": image_to_b64(out)}
        raise ValueError(f"unknown mode: {mode}")


def _extra(parser):
    parser.add_argument("--openseed-config", type=str, default="")
    parser.add_argument("--openseed-checkpoint", type=str, default="")
    parser.add_argument("--controlnet-path", type=str, default="")
    parser.add_argument("--sd-path", type=str, default="")


if __name__ == "__main__":
    tool_worker_main(OpenSeedControlNetWorker, 21044, ["controlnet"], _extra)
