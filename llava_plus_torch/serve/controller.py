"""Distributed serving controller.

Wire-compatible rebuild of ``llava/serve/controller.py`` (and its byte-
equivalent tool copy ``serve/controller.py``) on aiohttp. Differences are
fixes, not behavior changes:

- registry mutations hold a lock (the reference's heartbeat thread mutates
  ``worker_info`` racily, controller.py:173-191);
- the lottery's dead-worker probing branch is reachable via
  ``probe_on_dispatch`` instead of being short-circuited by ``if True``
  (controller.py:133).

The port's own copy of ``llava_plus_tpu/serve/controller.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from llava_plus_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION
from llava_plus_torch.serve.protocol import WorkerInfo, encode_chunk
from llava_plus_torch.utils.logging import build_logger, server_error_msg

logger = build_logger("controller", "controller.log")


class DispatchMethod:
    LOTTERY = "lottery"
    SHORTEST_QUEUE = "shortest_queue"

    @classmethod
    def from_str(cls, name: str) -> str:
        if name not in (cls.LOTTERY, cls.SHORTEST_QUEUE):
            raise ValueError("Invalid dispatch method")
        return name


class Controller:
    def __init__(
        self,
        dispatch_method: str = DispatchMethod.SHORTEST_QUEUE,
        *,
        heartbeat_expiration: float = CONTROLLER_HEART_BEAT_EXPIRATION,
        start_expiration_thread: bool = True,
        probe_on_dispatch: bool = False,
    ):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self.heartbeat_expiration = heartbeat_expiration
        self.probe_on_dispatch = probe_on_dispatch
        self._lock = threading.RLock()
        self._stop = threading.Event()
        if start_expiration_thread:
            t = threading.Thread(target=self._expiration_loop, daemon=True)
            t.start()
        logger.info("Init controller")

    # -- registry -----------------------------------------------------------

    def register_worker(
        self, worker_name: str, check_heart_beat: bool,
        worker_status: Optional[dict],
    ) -> bool:
        with self._lock:
            known = worker_name in self.worker_info
        logger.info(
            f"Register {'an existing' if known else 'a new'} worker: {worker_name}"
        )
        if not worker_status:
            worker_status = self.get_worker_status(worker_name)
        if not worker_status:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status["speed"],
                queue_length=worker_status["queue_length"],
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time(),
            )
        logger.info(f"Register done: {worker_name}, {worker_status}")
        return True

    def get_worker_status(self, worker_name: str) -> Optional[dict]:
        import requests

        try:
            r = requests.post(worker_name + "/worker_get_status", timeout=5)
        except requests.exceptions.RequestException as e:
            logger.error(f"Get status fails: {worker_name}, {e}")
            return None
        if r.status_code != 200:
            logger.error(f"Get status fails: {worker_name}, {r}")
            return None
        return r.json()

    def remove_worker(self, worker_name: str) -> None:
        with self._lock:
            self.worker_info.pop(worker_name, None)

    def refresh_all_workers(self) -> None:
        with self._lock:
            old_info = dict(self.worker_info)
            self.worker_info = {}
        for w_name, w_info in old_info.items():
            if not self.register_worker(w_name, w_info.check_heart_beat, None):
                logger.info(f"Remove stale worker: {w_name}")

    def list_models(self) -> List[str]:
        names = set()
        with self._lock:
            for w_info in self.worker_info.values():
                names.update(w_info.model_names)
        return list(names)

    # -- dispatch -----------------------------------------------------------

    def get_worker_address(self, model_name: str) -> str:
        if self.dispatch_method == DispatchMethod.LOTTERY:
            return self._dispatch_lottery(model_name)
        return self._dispatch_shortest_queue(model_name)

    def _candidates(self, model_name: str):
        with self._lock:
            return [
                (name, info) for name, info in self.worker_info.items()
                if model_name in info.model_names
            ]

    def _dispatch_lottery(self, model_name: str) -> str:
        """Speed-weighted random choice (ref controller.py:121-155)."""
        cands = self._candidates(model_name)
        names = [n for n, _ in cands]
        speeds = np.array([i.speed for _, i in cands], dtype=np.float32)
        while True:
            norm = float(np.sum(speeds))
            if norm < 1e-4:
                return ""
            pt = int(np.random.choice(np.arange(len(names)), p=speeds / norm))
            name = names[pt]
            if not self.probe_on_dispatch:
                return name
            if self.get_worker_status(name):
                return name
            self.remove_worker(name)
            speeds[pt] = 0.0

    def _dispatch_shortest_queue(self, model_name: str) -> str:
        cands = self._candidates(model_name)
        if not cands:
            return ""
        qlen = [info.queue_length / info.speed for _, info in cands]
        idx = int(np.argmin(qlen))
        name = cands[idx][0]
        with self._lock:
            if name in self.worker_info:
                self.worker_info[name].queue_length += 1
        logger.info(
            f"names: {[n for n, _ in cands]}, queue_lens: {qlen}, ret: {name}"
        )
        return name

    # -- liveness -----------------------------------------------------------

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                logger.info(f"Receive unknown heart beat. {worker_name}")
                return False
            self.worker_info[worker_name].queue_length = queue_length
            self.worker_info[worker_name].last_heart_beat = time.time()
        logger.info(f"Receive heart beat. {worker_name}")
        return True

    def remove_stale_workers_by_expiration(self) -> None:
        expire = time.time() - self.heartbeat_expiration
        with self._lock:
            to_delete = [
                name for name, info in self.worker_info.items()
                if info.check_heart_beat and info.last_heart_beat < expire
            ]
        for name in to_delete:
            self.remove_worker(name)

    def _expiration_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_expiration):
            self.remove_stale_workers_by_expiration()

    def stop(self) -> None:
        self._stop.set()

    # -- controller-as-worker (hierarchical topologies) ---------------------

    async def worker_api_generate_stream(self, params: dict):
        """Proxy a stream from the dispatched worker (async chunks)."""
        import aiohttp

        worker_addr = self.get_worker_address(params["model"])
        if not worker_addr:
            logger.info(f"no worker: {params['model']}")
            yield encode_chunk({"text": server_error_msg, "error_code": 2})
            return
        try:
            timeout = aiohttp.ClientTimeout(total=None, sock_connect=5, sock_read=100)
            async with aiohttp.ClientSession(timeout=timeout) as session:
                async with session.post(
                    worker_addr + "/worker_generate_stream", json=params
                ) as resp:
                    buffer = b""
                    async for data, _ in resp.content.iter_chunks():
                        buffer += data
                        while b"\0" in buffer:
                            part, buffer = buffer.split(b"\0", 1)
                            if part:
                                yield part + b"\0"
        except Exception:
            logger.info(f"worker timeout: {worker_addr}")
            yield encode_chunk({"text": server_error_msg, "error_code": 3})

    def worker_api_get_status(self) -> dict:
        model_names, speed, queue_length = set(), 0, 0
        with self._lock:
            names = list(self.worker_info)
        for name in names:
            status = self.get_worker_status(name)
            if status is not None:
                model_names.update(status["model_names"])
                speed += status["speed"]
                queue_length += status["queue_length"]
        return {
            "model_names": list(model_names),
            "speed": speed,
            "queue_length": queue_length,
        }


# ---------------------------------------------------------------------------
# HTTP app (aiohttp)
# ---------------------------------------------------------------------------

def build_app(controller: Controller):
    from aiohttp import web

    routes = web.RouteTableDef()

    @routes.post("/register_worker")
    async def register_worker(request):
        data = await request.json()
        controller.register_worker(
            data["worker_name"], data["check_heart_beat"],
            data.get("worker_status", None),
        )
        return web.json_response({})

    @routes.post("/refresh_all_workers")
    async def refresh_all_workers(request):
        controller.refresh_all_workers()
        return web.json_response({})

    @routes.post("/list_models")
    async def list_models(request):
        return web.json_response({"models": controller.list_models()})

    @routes.post("/get_worker_address")
    async def get_worker_address(request):
        data = await request.json()
        return web.json_response(
            {"address": controller.get_worker_address(data["model"])}
        )

    @routes.post("/receive_heart_beat")
    async def receive_heart_beat(request):
        data = await request.json()
        exist = controller.receive_heart_beat(
            data["worker_name"], data["queue_length"]
        )
        return web.json_response({"exist": exist})

    @routes.post("/worker_generate_stream")
    async def worker_generate_stream(request):
        params = await request.json()
        resp = web.StreamResponse()
        await resp.prepare(request)
        async for chunk in controller.worker_api_generate_stream(params):
            await resp.write(chunk)
        await resp.write_eof()
        return resp

    @routes.post("/worker_get_status")
    async def worker_get_status(request):
        return web.json_response(controller.worker_api_get_status())

    app = web.Application()
    app.add_routes(routes)
    return app


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument(
        "--dispatch-method", type=str,
        choices=["lottery", "shortest_queue"], default="shortest_queue",
    )
    return parser


def main(argv=None):
    from aiohttp import web

    args = build_parser().parse_args(argv)
    logger.info(f"args: {args}")

    controller = Controller(args.dispatch_method)
    web.run_app(build_app(controller), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
