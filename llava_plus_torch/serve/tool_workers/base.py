"""Tool-worker base: registration/heartbeat/status + sync /worker_generate.

Every reference tool worker (``serve/*_worker.py``, 14 of them) repeats the
same ~150 lines of FastAPI scaffolding; here it lives once. A concrete worker
subclasses :class:`ToolWorker` and implements ``generate(params) -> dict``
(tool-specific JSON in, ``pred_dict`` out). The wire protocol matches the
reference byte-for-byte: controller registration, heartbeats (every 15 s,
inside the controller's 30 s expiry; the reference beats every 45 s),
semaphore-limited ``POST /worker_generate``, FastChat error codes.

The port's own copy of ``llava_plus_tpu/serve/tool_workers/base.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import threading
import time
import uuid
from io import BytesIO
from typing import Dict, List, Optional

from PIL import Image

from llava_plus_torch.serve.tool_workers.constants import (
    ErrorCode,
    SERVER_ERROR_MSG,
    WORKER_HEART_BEAT_INTERVAL,
)
from llava_plus_torch.utils.logging import build_logger, pretty_print_semaphore

worker_id = str(uuid.uuid4())[:6]


def load_image(image: Optional[str]) -> Optional[Image.Image]:
    """Path-or-base64 image input (ref grounding_dino_worker.py:186-197)."""
    if not image:
        return None
    try:
        if len(image) < 4096 and "\n" not in image:
            import os

            if os.path.exists(image):
                return Image.open(image).convert("RGB")
    except (OSError, ValueError):
        pass
    return Image.open(BytesIO(base64.b64decode(image))).convert("RGB")


def image_to_b64(img: Image.Image) -> str:
    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class ToolWorker:
    """Protocol scaffold; subclass and implement ``generate``."""

    def __init__(
        self,
        controller_addr: str,
        worker_addr: str,
        model_names: List[str],
        *,
        limit_model_concurrency: int = 1,
        no_register: bool = False,
        heartbeats: bool = True,
    ):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_names = list(model_names)
        self.limit_model_concurrency = limit_model_concurrency
        self.semaphore: Optional[asyncio.Semaphore] = None
        self.logger = build_logger(
            self.__class__.__name__, f"tool_worker_{worker_id}.log"
        )
        self._stop = threading.Event()
        if not no_register and controller_addr:
            self.register_to_controller()
            if heartbeats:
                threading.Thread(
                    target=self._heartbeat_loop, daemon=True
                ).start()

    # -- to implement -------------------------------------------------------

    def generate(self, params: Dict) -> Dict:
        raise NotImplementedError

    # -- control plane (same as the LLM worker, slower cadence) -------------

    def register_to_controller(self):
        import requests

        self.logger.info("Register to controller")
        r = requests.post(self.controller_addr + "/register_worker", json={
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        })
        assert r.status_code == 200

    def _heartbeat_loop(self):
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            self.send_heart_beat()

    def send_heart_beat(self):
        import requests

        self.logger.info(
            f"Send heart beat. Models: {self.model_names}. "
            f"Semaphore: {pretty_print_semaphore(self.semaphore)}."
        )
        while True:
            try:
                ret = requests.post(
                    self.controller_addr + "/receive_heart_beat",
                    json={
                        "worker_name": self.worker_addr,
                        "queue_length": self.get_queue_length(),
                    }, timeout=5,
                )
                exist = ret.json()["exist"]
                break
            except Exception as e:
                self.logger.error(f"heart beat error: {e}")
            time.sleep(5)
        if not exist:
            self.register_to_controller()

    def get_queue_length(self) -> int:
        if self.semaphore is None:
            return 0
        waiters = self.semaphore._waiters
        return (
            self.limit_model_concurrency
            - self.semaphore._value
            + (len(waiters) if waiters is not None else 0)
        )

    def get_status(self) -> Dict:
        return {
            "model_names": self.model_names,
            "speed": 1,
            "queue_length": self.get_queue_length(),
        }

    def stop(self):
        self._stop.set()

    # -- data plane ---------------------------------------------------------

    def generate_gate(self, params: Dict) -> Dict:
        try:
            return self.generate(params)
        except ValueError as e:
            self.logger.error(f"ValueError: {e}")
            return {
                "text": f"{SERVER_ERROR_MSG}\n\n({e})",
                "error_code": ErrorCode.PARAM_OUT_OF_RANGE,
            }
        except Exception as e:
            self.logger.error(f"Unknown error: {e}")
            return {
                "text": f"{SERVER_ERROR_MSG}\n\n({e})",
                "error_code": ErrorCode.INTERNAL_ERROR,
            }


def build_tool_app(worker: ToolWorker):
    from aiohttp import web

    routes = web.RouteTableDef()

    @routes.post("/worker_generate")
    async def worker_generate(request):
        params = await request.json()
        if worker.semaphore is None:
            worker.semaphore = asyncio.Semaphore(worker.limit_model_concurrency)
        await worker.semaphore.acquire()
        try:
            loop = asyncio.get_event_loop()
            result = await loop.run_in_executor(
                None, worker.generate_gate, params
            )
        finally:
            worker.semaphore.release()
        return web.json_response(result)

    @routes.post("/worker_get_status")
    async def worker_get_status(request):
        return web.json_response(worker.get_status())

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.add_routes(routes)
    return app


def tool_worker_main(worker_cls, default_port: int, default_names: List[str],
                     extra_args=None):
    """Shared CLI main for every tool worker."""
    from aiohttp import web

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=default_port)
    parser.add_argument("--worker-address", type=str, default=None)
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--model-names", type=str,
                        default=",".join(default_names))
    parser.add_argument("--limit-model-concurrency", type=int, default=1)
    parser.add_argument("--no-register", action="store_true")
    if extra_args:
        extra_args(parser)
    args = parser.parse_args()
    worker_addr = args.worker_address or f"http://localhost:{args.port}"
    worker = worker_cls(
        args.controller_address, worker_addr,
        args.model_names.split(","),
        limit_model_concurrency=args.limit_model_concurrency,
        no_register=args.no_register,
        args=args,
    )
    web.run_app(build_tool_app(worker), host=args.host, port=args.port)
