"""LLaVA-Plus tool-use orchestration — the two-round loop, as a library.

Rebuild of the loop embedded in the reference's gradio callback
(``llava/serve/gradio_web_server_llava_plus.py:350-737``), decoupled from any
UI so the CLI, web server, eval harness, and tests all drive the same code:

  round 1: stream model -> parse "thoughts🤔 / actions🚀 / value👉"
  dispatch: exactly one tool through the controller registry
            (per-tool param surgery preserved: inpainting mask cache,
            openseed/controlnet mode, seem reference image/mask)
  fold:     round floats, pop image payloads, cache mask state
  round 2:  "{api} model outputs: {...} Please summarize the model outputs
            and answer my first question: {q}" -> stream again
  render:   overlay boxes/masks/points on the input image

Differences from the reference are deliberate fixes: actions parse with
``json.loads`` only (never eval), and dispatch state lives in an explicit
``ToolSession`` instead of attributes monkey-patched onto the conversation.

The port's own copy of ``llava_plus_tpu/serve/orchestrator.py``.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json
from io import BytesIO
from typing import Any, Dict, List, Optional, Tuple

import requests
from PIL import Image

from llava_plus_torch.conversation import Conversation, parse_tool_output
from llava_plus_torch.serve.annotation import (
    draw_boxes,
    draw_masks,
    draw_points,
    rle_to_mask,
)
from llava_plus_torch.serve.protocol import iter_chunks_requests
from llava_plus_torch.utils.logging import build_logger

logger = build_logger("orchestrator", "orchestrator.log")

R = lambda x: round(float(x), 2)  # noqa: E731  (the reference's rounding)


def _round_nested(x):
    """``R`` at any depth of nested lists: xyxy boxes and the OCR schema's
    polygons (lists of points) alike."""
    if isinstance(x, (list, tuple)):
        return [_round_nested(v) for v in x]
    return R(x)

headers = {"User-Agent": "LLaVA-Plus-TPU Client"}


def get_worker_addr(controller_addr: str, worker_name: str) -> str:
    """Resolve a model/tool name through the controller registry
    (ref gradio_web_server_llava_plus.py:156-174)."""
    if worker_name.startswith("http"):
        return worker_name
    ret = requests.post(
        controller_addr + "/get_worker_address", json={"model": worker_name}
    )
    return ret.json()["address"]


@dataclasses.dataclass
class ToolSession:
    """Cross-turn tool state (the reference caches these on `state`)."""

    mask_rle: Optional[Dict] = None
    image_seg: Optional[str] = None
    reference_image: Optional[str] = None
    reference_mask: Optional[Any] = None


def get_mask_bbox(mask_img: Image.Image) -> Optional[List[float]]:
    """Bounding box of a sketch mask, normalized to [0,1] and 2-dp rounded
    (ref gradio_web_server_llava_plus.py:77-97). Returns None for an empty
    mask. The UI appends it to the prompt as ``Input box: [x0,y0,x1,y1]``."""
    import numpy as np

    mask = np.array(mask_img)
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.sum() == 0:
        return None
    coords = np.argwhere(mask > 0)
    y0, x0 = coords.min(axis=0)
    y1, x1 = coords.max(axis=0) + 1
    h, w = mask.shape[:2]
    return [R(x0 / w), R(y0 / h), R(x1 / w), R(y1 / h)]


@dataclasses.dataclass
class ToolTurnResult:
    text: str
    round1_text: str
    api_name: Optional[str]
    tool_response: Optional[Dict]
    annotated_image: Optional[Image.Image]
    error: Optional[str] = None


def parse_tool_cfg(model_output_text: str):
    """Extract the actions JSON (ref :498-514; json.loads only)."""
    matches = parse_tool_output(model_output_text)
    if matches is None:
        return None
    actions_text = matches[0][1].strip()
    try:
        return json.loads(actions_text)
    except Exception:
        try:
            return json.loads(actions_text.replace("'", '"'))
        except Exception as e:
            logger.info(f"Failed to parse tool config: {e}")
            return None


def prepare_tool_call(
    tool_cfg: List[Dict],
    image_b64: Optional[str],
    session: ToolSession,
) -> Tuple[str, Dict]:
    """Per-tool param surgery (ref :516-556)."""
    assert len(tool_cfg) == 1, (
        f"Only one tool is supported for now, but got: {tool_cfg}"
    )
    api_name = tool_cfg[0]["API_name"]
    params = dict(tool_cfg[0].get("API_params", {}))
    params.pop("image", None)
    api_paras = {
        "image": image_b64,
        "box_threshold": 0.3,
        "text_threshold": 0.25,
        **params,
    }
    if api_name in ("inpainting",):
        api_paras["mask"] = session.mask_rle
    if api_name in ("openseed", "controlnet"):
        if api_name == "controlnet":
            api_paras["mask"] = session.image_seg
        api_paras["mode"] = api_name
        api_name = "controlnet"
    if api_name == "seem":
        api_paras["refimg"] = session.reference_image
        api_paras["refmask"] = session.reference_mask
    return api_name, api_paras


def fold_tool_response(
    api_name: str, tool_response: Dict, session: ToolSession
) -> Tuple[Dict, Dict]:
    """Round numbers, pop image payloads, cache masks (ref :560-596).
    Returns (folded_response_for_prompt, extracted_artifacts)."""
    tool_response = copy.deepcopy(tool_response)
    artifacts: Dict[str, Any] = {}
    if api_name == "easyocr":
        tool_response.pop("boxes", None)
        tool_response.pop("scores", None)
    for key in ("boxes", "logits", "scores"):
        if key in tool_response:
            tool_response[key] = _round_nested(tool_response[key])
    if "masks_rle" in tool_response:
        artifacts["masks_rle"] = tool_response.pop("masks_rle")
    if "edited_image" in tool_response:
        artifacts["edited_image"] = tool_response.pop("edited_image")
    if "size" in tool_response:
        tool_response.pop("size")
    if "retrieval_results" in tool_response:
        tool_response["retrieval_results"] = [
            {"caption": r["caption"], "similarity": R(r["similarity"])}
            for r in tool_response["retrieval_results"]
        ]
    if "image_seg" in tool_response:
        artifacts["image_seg"] = tool_response.pop("image_seg")
    if "iou_sort_masks" in tool_response:
        artifacts["iou_sort_masks"] = tool_response.pop("iou_sort_masks")
    if len(tool_response) == 0:
        tool_response["message"] = f"The {api_name} has processed the image."
    if artifacts.get("masks_rle"):
        session.mask_rle = artifacts["masks_rle"][0]
    if artifacts.get("image_seg") is not None:
        session.image_seg = artifacts["image_seg"]
    return tool_response, artifacts


def build_round2_message(api_name: str, tool_response: Dict,
                         first_question: str) -> str:
    """Byte-format of the round-2 user message (ref :602-613)."""
    new_response = f"{api_name} model outputs: {tool_response}\n\n"
    return (
        new_response
        + "Please summarize the model outputs and answer my first question: {}".format(
            first_question.strip()
        )
    )


def annotate_result(
    image: Image.Image,
    tool_response: Dict,
    artifacts: Dict,
) -> Optional[Image.Image]:
    """Overlay boxes/masks/points; decode edited images (ref :662-717)."""
    out = None
    if artifacts.get("edited_image"):
        return Image.open(
            BytesIO(base64.b64decode(artifacts["edited_image"]))
        ).convert("RGB")
    boxes = tool_response.get("boxes")
    phrases = tool_response.get("phrases")
    if boxes:
        # an OCR polygon (a list of points) is drawn as its bounding box
        boxes = [[min(p[0] for p in b), min(p[1] for p in b),
                  max(p[0] for p in b), max(p[1] for p in b)]
                 if b and isinstance(b[0], (list, tuple)) else b for b in boxes]
        out = draw_boxes(image, boxes, phrases)
    if artifacts.get("masks_rle"):
        masks = [rle_to_mask(r) for r in artifacts["masks_rle"]]
        out = draw_masks(out or image, masks)
    if "points" in tool_response and tool_response["points"]:
        out = draw_points(out or image, tool_response["points"])
    return out


class ToolOrchestrator:
    """Drives the full two-round tool loop against a controller topology."""

    def __init__(self, controller_addr: str):
        self.controller_addr = controller_addr

    def stream_model(self, model_name: str, prompt: str,
                     images_b64: Optional[List[str]] = None,
                     **gen_params):
        """Stream from an LLM worker; yields cumulative response text
        (with the prompt prefix stripped)."""
        worker_addr = get_worker_addr(self.controller_addr, model_name)
        if not worker_addr:
            raise RuntimeError(f"no worker for model {model_name}")
        pload = {
            "model": model_name,
            "prompt": prompt,
            "temperature": float(gen_params.get("temperature", 0.2)),
            "top_p": float(gen_params.get("top_p", 0.7)),
            "max_new_tokens": int(gen_params.get("max_new_tokens", 512)),
            "stop": gen_params.get("stop"),
        }
        if images_b64:
            pload["images"] = images_b64
        resp = requests.post(
            worker_addr + "/worker_generate_stream",
            headers=headers, json=pload, stream=True, timeout=100,
        )
        for data in iter_chunks_requests(resp):
            if data.get("error_code", 0) != 0:
                raise RuntimeError(data.get("text", "worker error"))
            yield data["text"][len(prompt):].strip()

    def call_tool(self, api_name: str, api_paras: Dict) -> Dict:
        addr = get_worker_addr(self.controller_addr, api_name)
        if not addr:
            raise RuntimeError(f"no worker for tool {api_name}")
        return requests.post(
            addr + "/worker_generate", headers=headers, json=api_paras,
            timeout=300,
        ).json()

    def stream_turn(
        self,
        conv: Conversation,
        model_name: str,
        user_message: str,
        image: Optional[Image.Image] = None,
        session: Optional[ToolSession] = None,
        **gen_params,
    ):
        """One full user turn as an event stream (browser streaming — the
        reference UIs yield partial state per chunk,
        ref gradio_web_server_llava_plus.py:460-487, 634-659). Yields dicts:

          {"round": 1|2, "text": cumulative}   streamed model text
          {"prog": round1_text}                raw thoughts/actions ("Prog"
                                               debug view, ref :286-298)
          {"status": str}                      tool dispatch progress
          {"api_name": str, "tool_response": dict}  folded output (transcript
                                               folding, ref conversation.py
                                               merge_output :258-371)
          {"image": b64-png}                   annotated result image
          {"error": str}                       tool dispatch failure
          {"final": ToolTurnResult}            always last
        """
        session = session if session is not None else ToolSession()

        image_b64 = None
        if image is not None:
            buf = BytesIO()
            image.save(buf, format="PNG")
            image_b64 = base64.b64encode(buf.getvalue()).decode()
            if "<image>" not in user_message and len(conv.messages) == 0:
                user_message = "<image>\n" + user_message
        conv.append_message(conv.roles[0], user_message)
        conv.append_message(conv.roles[1], None)

        round1 = ""
        for round1 in self.stream_model(
            model_name, conv.get_prompt(),
            [image_b64] if image_b64 else None, **gen_params,
        ):
            yield {"round": 1, "text": round1}
        conv.messages[-1][-1] = round1

        tool_cfg = parse_tool_cfg(round1)
        if not tool_cfg:
            yield {"final": ToolTurnResult(
                text=round1, round1_text=round1, api_name=None,
                tool_response=None, annotated_image=None,
            )}
            return

        yield {"prog": round1}
        try:
            api_name, api_paras = prepare_tool_call(tool_cfg, image_b64, session)
            yield {"status": f"calling {api_name}..."}
            raw_response = self.call_tool(api_name, api_paras)
            folded, artifacts = fold_tool_response(api_name, raw_response, session)
        except Exception as e:
            logger.error(f"tool dispatch failed: {e}")
            yield {"error": str(e)}
            yield {"final": ToolTurnResult(
                text=round1, round1_text=round1, api_name=None,
                tool_response=None, annotated_image=None, error=str(e),
            )}
            return
        yield {"api_name": api_name, "tool_response": folded}

        conv.append_message(
            conv.roles[0],
            build_round2_message(api_name, folded, user_message.replace("<image>", "")),
        )
        conv.append_message(conv.roles[1], None)
        round2 = ""
        for round2 in self.stream_model(
            model_name, conv.get_prompt(),
            [image_b64] if image_b64 else None, **gen_params,
        ):
            yield {"round": 2, "text": round2}
        conv.messages[-1][-1] = round2

        annotated = (
            annotate_result(image, folded, artifacts) if image is not None else None
        )
        if annotated is not None:
            buf = BytesIO()
            annotated.save(buf, format="PNG")
            yield {"image": base64.b64encode(buf.getvalue()).decode()}
        yield {"final": ToolTurnResult(
            text=round2, round1_text=round1, api_name=api_name,
            tool_response=folded, annotated_image=annotated,
        )}

    def run_turn(
        self,
        conv: Conversation,
        model_name: str,
        user_message: str,
        image: Optional[Image.Image] = None,
        session: Optional[ToolSession] = None,
        **gen_params,
    ) -> ToolTurnResult:
        """One full user turn: round 1, optional tool dispatch, round 2.
        Collecting wrapper over :meth:`stream_turn`."""
        result = None
        for event in self.stream_turn(
            conv, model_name, user_message, image=image, session=session,
            **gen_params,
        ):
            if "final" in event:
                result = event["final"]
        return result
