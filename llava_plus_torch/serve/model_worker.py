"""Model worker: the HTTP surface of one served model, and the PyTorch backend.

The port's own copy of ``llava_plus_tpu/serve/model_worker.py``'s
``ModelWorker``, ``heart_beat_worker`` and ``build_app`` (wire-compatible with
the reference's worker: registration, heartbeats, semaphore-limited
``/worker_generate_stream`` with b"\\0"-delimited cumulative-text chunks), with
``/worker_profile_start|stop`` on ``torch.profiler``. :class:`TorchBackend`
sits behind the worker's backend seam: by default requests go through the
continuous-batching :class:`~llava_plus_torch.serve.engine.BatchedEngine`
(dense or paged KV), as the JAX worker serves them; ``use_engine=False``
serves one request at a time through the single-stream
:class:`~llava_plus_torch.generate.Generator`.

    python -m llava_plus_torch.serve.model_worker --model-path DIR \
        [--model-base BASE] [--load-8bit | --load-4bit] [--kv-int8] [--paged] \
        [--tp N] [--device cuda|cpu] [--no-register] ...

:func:`main` takes the JAX worker's flags, plus ``--device`` (``cuda`` unless
the caller asks for ``cpu``), loads the checkpoint through
``models/builder.load_pretrained_model`` and serves it with
:class:`TorchBackend` (:func:`load_backend`, :func:`backend_for`). Without a
model path, or with ``--echo``, it serves the protocol-test
:class:`EchoBackend`.

``--tp N`` serves one model over N ranks, one process a card
(``parallel/tp.py``): the worker spawns N - 1 follower processes (NCCL on
``cuda:r``, or gloo with ``--device cpu``), each of which dies with it, and
becomes rank 0. Rank 0 loads the checkpoint and sends it leaf by leaf, each
rank keeping its slice (``models/builder.load_sharded_model``); only rank 0
serves HTTP, registers and beats, and the followers replay its engine's
device calls until it stops.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
import threading
import time
import uuid
from typing import Iterator, Optional

import torch

from llava_plus_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    WORKER_HEART_BEAT_INTERVAL,
)
from llava_plus_torch.generate import Generator
from llava_plus_torch.mm_utils import load_image_from_base64, process_images
from llava_plus_torch.models.convert import tree_map
from llava_plus_torch.ops.quant import quantize_llava_params
from llava_plus_torch.serve.engine import BatchedEngine, Request
from llava_plus_torch.serve.protocol import encode_chunk, iter_chunks_requests  # noqa: F401
from llava_plus_torch.utils.logging import (
    build_logger,
    pretty_print_semaphore,
    server_error_msg,
)

worker_id = str(uuid.uuid4())[:6]
# handlers (console and a log file) are attached when a ModelWorker is made
logger = logging.getLogger("model_worker")


class EchoBackend:
    """Protocol-test backend: streams the prompt and a canned echo."""

    is_multimodal = True
    context_len = 2048

    def __init__(self, reply: str = "echo: ok", delay: float = 0.0):
        self.reply = reply
        self.delay = delay

    def generate_stream(self, params: dict) -> Iterator[str]:
        text = params["prompt"]
        stop = params.get("stop")
        for piece in self.reply.split(" "):
            if self.delay:
                time.sleep(self.delay)
            text += " " + piece
            yield text[: -len(stop)] if stop and text.endswith(stop) else text


class TorchBackend:
    """Backend over in-memory parameters on ``device``.

    ``quantize="int8"`` / ``"int4"`` quantizes the language model's matrices
    in place (the caller's tree is consumed) and fuses LLaMA's (``wqkv``,
    ``w_gateup``; MPT's ``wqkv`` is one matrix already): the port's
    ``--load-8bit`` / ``--load-4bit``. ``cfg`` may name either backbone.
    ``kv_int8`` stores the KV cache as int8 with per-(token, head) scales.
    ``paged=True`` serves over a paged KV pool of ``pool_tokens`` tokens
    (default ``max_slots * max_seq_len``) with the prefix cache on unless
    ``prefix_cache=False``, as the JAX worker's ``--paged``. ``max_seq_len``
    overrides the context length (a paged pool makes contexts past 2048
    practical). ``speculate=k`` serves with prompt-lookup speculation, k
    proposals verified a step and ``spec_chunk`` steps a dispatch, as the
    JAX worker's ``--speculate`` / ``--spec-chunk``. ``warmup_len`` > 0
    warms the engine at that prompt length before the first request.
    ``w8a8`` gives the engine int8 activations for its prefills (the JAX
    worker's ``--w8a8``; the single-stream Generator ignores it, as in JAX).
    ``mesh`` serves over tensor parallelism (the engine's or the Generator's
    ``mesh``): every rank makes its backend with the same arguments, over
    the whole tree (quantized here, whole, before it is cut) or its own
    shard; rank 0 serves and every other rank calls :meth:`follow`."""

    def __init__(self, params, cfg, tokenizer, image_processor=None, *,
                 device, use_engine: bool = True, max_slots: int = 8,
                 decode_chunk: int = 4, quantize: Optional[str] = None,
                 kv_int8: bool = False, max_seq_len: Optional[int] = None,
                 paged: bool = False, pool_tokens: Optional[int] = None,
                 prefix_cache: bool = True, speculate: int = 0, spec_chunk: int = 4,
                 warmup_len: int = 0, stream_interval: int = 1, w8a8: bool = False,
                 mesh=None):
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"quantize must be None, 'int8' or 'int4', got {quantize!r}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.context_len = max_seq_len or cfg.max_sequence_length
        # a text-only checkpoint (the builder's plain-LM path) has no tower
        self.is_multimodal = bool(params.get("vision_tower"))
        self.stream_interval = max(int(stream_interval or 1), 1)
        if quantize:
            params = quantize_llava_params(params, cfg.language_model_type,
                                           bits=4 if quantize == "int4" else 8, fuse=True)
        cache_dtype = torch.int8 if kv_int8 else torch.bfloat16
        self.engine = None
        self.generator = None
        if use_engine:
            self.engine = BatchedEngine(params, cfg, tokenizer, max_slots=max_slots,
                                        max_seq_len=self.context_len,
                                        decode_chunk=decode_chunk, cache_dtype=cache_dtype,
                                        paged=paged, pool_tokens=pool_tokens,
                                        prefix_cache=prefix_cache, speculate=speculate,
                                        spec_chunk=spec_chunk, w8a8=w8a8, mesh=mesh)
            if warmup_len and self.engine.leader:
                self.engine.warmup(prompt_len=warmup_len, image=self.is_multimodal)
        else:
            self.generator = Generator(params, cfg, tokenizer, image_processor, device=device,
                                       max_seq_len=self.context_len, cache_dtype=cache_dtype,
                                       mesh=mesh)

    def follow(self) -> int:
        """A follower rank's loop (under ``mesh``): replay rank 0's device
        calls until its :meth:`stop`."""
        return (self.engine or self.generator).follow()

    def stop(self):
        """Stop the engine's threads and, under tensor parallelism, the
        followers (rank 0)."""
        if self.engine is not None:
            self.engine.stop()
        if self.generator is not None:
            self.generator.stop()

    def generate_stream(self, params: dict) -> Iterator[str]:
        """One request of the worker's protocol: the JAX backend's request
        handling (image count, ``<image>`` accounting, token budget, greedy
        below temperature 0.001, stop string, ``stream_interval``), served by
        the port's engine or generator. Yields cumulative text."""
        prompt = params["prompt"]
        ori_prompt = prompt
        images = params.get("images", None)
        num_image_tokens = 0
        image_arrays = None
        if images is not None and len(images) > 0 and self.is_multimodal:
            if len(images) != prompt.count(DEFAULT_IMAGE_TOKEN):
                raise ValueError(
                    "Number of images does not match number of <image> tokens in prompt")
            pil_images = [load_image_from_base64(im) for im in images]
            image_arrays = process_images(pil_images, self.image_processor, self.cfg)
            replace_token = DEFAULT_IMAGE_TOKEN
            if self.cfg.mm_use_im_start_end:
                replace_token = DEFAULT_IM_START_TOKEN + replace_token + DEFAULT_IM_END_TOKEN
            prompt = prompt.replace(DEFAULT_IMAGE_TOKEN, replace_token)
            num_image_tokens = prompt.count(replace_token) * self.cfg.num_image_tokens

        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)
        if temperature <= 0.001:
            temperature = 0.0

        prompt_tokens = len(self.tokenizer(prompt).input_ids)
        max_new_tokens = min(max_new_tokens,
                             self.context_len - prompt_tokens - num_image_tokens)
        if max_new_tokens < 1:
            yield ori_prompt + "Exceeds max token length. Please start a new conversation, thanks."
            return

        stop_strings = [stop_str] if stop_str else []
        if self.engine is not None:
            stream = self.engine.stream(Request(
                prompt=prompt, images=image_arrays, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, stop_strings=stop_strings))
        else:
            stream = self.generator.stream(
                prompt, images=image_arrays, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, stop_strings=stop_strings)
        # push every stream_interval-th cumulative update, and the final one
        n, last = 0, None
        for text in stream:
            n += 1
            if n % self.stream_interval == 0:
                yield ori_prompt + text
                last = None
            else:
                last = text
        if last is not None:
            yield ori_prompt + last


def heart_beat_worker(worker: "ModelWorker"):
    while not worker._stop.wait(WORKER_HEART_BEAT_INTERVAL):
        worker.send_heart_beat()


class ModelWorker:
    def __init__(
        self,
        controller_addr: str,
        worker_addr: str,
        backend,
        model_names,
        *,
        limit_model_concurrency: int = 5,
        no_register: bool = False,
        heartbeats: bool = True,
    ):
        build_logger("model_worker", f"model_worker_{worker_id}.log")
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.backend = backend
        self.model_names = list(model_names)
        self.limit_model_concurrency = limit_model_concurrency
        self.semaphore: Optional[asyncio.Semaphore] = None
        self.global_counter = 0
        self.metrics: dict = {}
        self.profiler = None  # a running torch.profiler session (/worker_profile_*)
        self._stop = threading.Event()
        self.no_register = no_register
        if not no_register:
            self.register_to_controller()
            if heartbeats:
                t = threading.Thread(
                    target=heart_beat_worker, args=(self,), daemon=True
                )
                t.start()

    # -- control plane ------------------------------------------------------

    def register_to_controller(self):
        import requests

        logger.info("Register to controller")
        url = self.controller_addr + "/register_worker"
        data = {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        }
        r = requests.post(url, json=data)
        assert r.status_code == 200

    def send_heart_beat(self):
        import requests

        logger.info(
            f"Send heart beat. Models: {self.model_names}. "
            f"Semaphore: {pretty_print_semaphore(self.semaphore)}. "
            f"global_counter: {self.global_counter}"
        )
        url = self.controller_addr + "/receive_heart_beat"
        while True:
            try:
                ret = requests.post(url, json={
                    "worker_name": self.worker_addr,
                    "queue_length": self.get_queue_length(),
                }, timeout=5)
                exist = ret.json()["exist"]
                break
            except Exception as e:
                logger.error(f"heart beat error: {e}")
            time.sleep(5)
        if not exist:
            self.register_to_controller()

    def get_queue_length(self) -> int:
        if (
            self.semaphore is None
            or self.semaphore._value is None
            or self.semaphore._waiters is None
        ):
            return 0
        return (
            self.limit_model_concurrency
            - self.semaphore._value
            + len(self.semaphore._waiters)
        )

    def get_status(self) -> dict:
        return {
            "model_names": self.model_names,
            "speed": 1,
            "queue_length": self.get_queue_length(),
        }

    def stop(self):
        self._stop.set()

    # -- observability ------------------------------------------------------
    # (the reference has none beyond heartbeat logs — SURVEY.md §5)

    def get_metrics(self) -> dict:
        m = dict(self.metrics)
        n = max(m.pop("_requests", 0), 1)
        m["requests"] = self.metrics.get("_requests", 0)
        m["mean_ttft_s"] = m.pop("_ttft_sum", 0.0) / n
        total_decode = m.pop("_decode_time_sum", 0.0)
        m["decode_tok_s"] = (
            m.get("_tokens_sum", 0) / total_decode if total_decode else 0.0
        )
        m["total_tokens"] = m.pop("_tokens_sum", 0)
        if torch.cuda.is_initialized():
            m["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        engine = getattr(self.backend, "engine", None)
        if engine is not None:
            m["engine_active_slots"] = engine.num_active
            m["engine_max_slots"] = engine.max_slots
            m["engine_prefill_dispatches"] = engine.prefill_dispatches
            m["engine_prefill_requests"] = engine.prefill_requests
            if engine._prefix is not None:
                m["engine_prefix_entries"] = len(engine._prefix)
                m["engine_prefix_lookups"] = engine._prefix.lookups
                m["engine_prefix_hits"] = engine._prefix.hit_requests
                m["engine_prefix_hit_tokens"] = engine.prefix_hit_tokens
        return m

    # -- profiling ----------------------------------------------------------

    def profile_start(self, log_dir: str) -> None:
        """Start a ``torch.profiler`` session (the card too, when there is
        one); :meth:`profile_stop` writes its Chrome trace into ``log_dir``."""
        if self.profiler is not None:
            raise RuntimeError("a profile is already running")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self.profiler, self.profile_dir = prof, log_dir

    def profile_stop(self) -> str:
        prof, self.profiler = self.profiler, None
        if prof is None:
            raise RuntimeError("no profile is running")
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"worker_{self.worker_id}_trace.json")
        prof.export_chrome_trace(path)
        return path

    # -- data plane ---------------------------------------------------------

    def generate_stream_gate(self, params: dict) -> Iterator[bytes]:
        """Error-gated stream: text chunks -> wire chunks
        (ref model_worker.py:194-218), with TTFT/decode-rate accounting."""
        t0 = time.perf_counter()
        first_t = None
        n_chunks = 0
        try:
            for text in self.backend.generate_stream(params):
                if first_t is None:
                    first_t = time.perf_counter()
                n_chunks += 1
                yield encode_chunk({"text": text, "error_code": 0})
        except ValueError as e:
            logger.error(f"Caught ValueError: {e}")
            yield encode_chunk({
                "text": f"{server_error_msg}\n\n({e})", "error_code": 1,
            })
        except Exception as e:
            logger.error(f"Caught Unknown Error: {e}")
            yield encode_chunk({
                "text": f"{server_error_msg}\n\n({e})", "error_code": 1,
            })
        finally:
            end = time.perf_counter()
            self.metrics["_requests"] = self.metrics.get("_requests", 0) + 1
            if first_t is not None:
                self.metrics["_ttft_sum"] = (
                    self.metrics.get("_ttft_sum", 0.0) + (first_t - t0)
                )
                self.metrics["_decode_time_sum"] = (
                    self.metrics.get("_decode_time_sum", 0.0) + (end - first_t)
                )
                self.metrics["_tokens_sum"] = (
                    self.metrics.get("_tokens_sum", 0) + n_chunks
                )


# ---------------------------------------------------------------------------
# HTTP app (aiohttp)
# ---------------------------------------------------------------------------

def build_app(worker: ModelWorker):
    from concurrent.futures import ThreadPoolExecutor

    from aiohttp import web

    routes = web.RouteTableDef()
    # each admitted stream waits for its next chunk in a thread of its own;
    # the loop's default executor has only cpu_count + 4 threads
    executor = ThreadPoolExecutor(max_workers=worker.limit_model_concurrency + 4)

    @routes.post("/worker_generate_stream")
    async def worker_generate_stream(request):
        params = await request.json()
        worker.global_counter += 1
        if worker.semaphore is None:
            worker.semaphore = asyncio.Semaphore(worker.limit_model_concurrency)
        await worker.semaphore.acquire()
        if not worker.no_register:
            # per-request queue-length heartbeat (ref model_worker.py:239);
            # skipped standalone — the reference retries a nonexistent
            # controller forever here, wedging the response (ref bug)
            worker.send_heart_beat()
        resp = web.StreamResponse()
        await resp.prepare(request)
        loop = asyncio.get_event_loop()
        try:
            gen = worker.generate_stream_gate(params)
            while True:
                chunk = await loop.run_in_executor(executor, next, gen, None)
                if chunk is None:
                    break
                await resp.write(chunk)
        finally:
            worker.semaphore.release()
            if not worker.no_register:
                worker.send_heart_beat()
        await resp.write_eof()
        return resp

    @routes.post("/worker_get_status")
    async def worker_get_status(request):
        return web.json_response(worker.get_status())

    @routes.post("/worker_metrics")
    async def worker_metrics(request):
        return web.json_response(worker.get_metrics())

    @routes.post("/worker_profile_start")
    async def worker_profile_start(request):
        """Start a torch.profiler trace (open the JSON in chrome://tracing
        or Perfetto)."""
        data = await request.json()
        log_dir = data.get("log_dir", "profile_out")
        worker.profile_start(log_dir)
        return web.json_response({"log_dir": log_dir})

    @routes.post("/worker_profile_stop")
    async def worker_profile_stop(request):
        return web.json_response({"trace": worker.profile_stop()})

    async def shutdown_executor(app):
        executor.shutdown(wait=False)

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.add_routes(routes)
    app.on_cleanup.append(shutdown_executor)
    return app


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    """The JAX worker's flags, plus ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--worker-address", type=str, default="http://localhost:21002")
    parser.add_argument("--controller-address", type=str, default="http://localhost:21001")
    parser.add_argument("--model-path", type=str, default=None)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--echo", action="store_true",
                        help="protocol-test echo backend (no model)")
    parser.add_argument("--load-8bit", action="store_true",
                        help="weight-only int8 serving (fused, the CUDA int8 matmul)")
    parser.add_argument("--load-4bit", action="store_true",
                        help="weight-only blockwise int4 serving (the CUDA int4 matmul)")
    parser.add_argument("--decode-chunk", type=int, default=4,
                        help="decode steps between the engine's host syncs")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV cache with per-token, per-head scales")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel serving over N cards (one process a card)")
    parser.add_argument("--max-slots", type=int, default=8,
                        help="continuous-batching slot count")
    parser.add_argument("--no-engine", action="store_true",
                        help="no continuous batching: one request at a time")
    parser.add_argument("--paged", action="store_true",
                        help="paged KV pool with the prefix cache")
    parser.add_argument("--no-prefix-cache", action="store_true",
                        help="no prefix reuse over the paged pool")
    parser.add_argument("--max-seq-len", type=int, default=None,
                        help="override the context length")
    parser.add_argument("--pool-tokens", type=int, default=None,
                        help="KV pool size in tokens (default max_slots * max_seq_len)")
    parser.add_argument("--rope-scaling", type=str, default=None,
                        help="override rope scaling, e.g. dynamic:2.0 or linear:4.0")
    parser.add_argument("--speculate", type=int, default=0,
                        help="prompt-lookup speculative decoding: proposals verified a "
                             "step (greedy-exact; 0 = off, at most 7)")
    parser.add_argument("--w8a8", action="store_true",
                        help="int8 activations for the engine's int8 matmuls of 256 rows "
                             "or more (the prefills; ignored without the engine)")
    parser.add_argument("--spec-chunk", type=int, default=4,
                        help="verify steps per dispatch (with --speculate)")
    parser.add_argument("--warmup", type=int, default=768, metavar="LEN",
                        help="warm the engine at prompts of ~LEN fused tokens before "
                             "registering; 0 disables")
    parser.add_argument("--stream-interval", type=int, default=1,
                        help="push every Nth streamed update")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to serve on (cpu only when asked for)")
    parser.add_argument("--multi-modal", action="store_true",
                        help="accepted for reference-CLI compatibility; multimodality "
                             "follows the checkpoint")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Exit with a message for a CUDA device on a machine without one (the
    worker never falls back to the CPU) or with fewer cards than ``--tp``."""
    if args.echo or args.model_path is None:
        return
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp}: at least one rank")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available; pass "
                             "--device cpu to serve on the CPU")
        if args.tp > torch.cuda.device_count():
            raise SystemExit(f"--tp {args.tp}: only {torch.cuda.device_count()} CUDA devices")


def _rope_scaled(cfg, rope_scaling: str):
    """``cfg`` with "linear:<factor>" or "dynamic:<factor>" rope scaling
    (serve a checkpoint past its trained context)."""
    typ, _, fac = rope_scaling.partition(":")
    if typ not in ("linear", "dynamic"):
        raise SystemExit(f"--rope-scaling: unsupported type {typ!r} "
                         "(expected 'linear:<factor>' or 'dynamic:<factor>')")
    try:
        factor = float(fac or 2.0)
    except ValueError:
        raise SystemExit(f"--rope-scaling: factor {fac!r} is not a number "
                         "(expected e.g. 'linear:4.0')") from None
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, rope_scaling_type=typ, rope_scaling_factor=factor))


def _quantize_flag(args: argparse.Namespace) -> Optional[str]:
    return "int4" if args.load_4bit else "int8" if args.load_8bit else None


def advise_load_4bit(args: argparse.Namespace, name: Optional[str]) -> None:
    """The JAX worker's advice on ``--load-4bit`` (its condition: a model
    whose name lacks "13b"): int4 buys capacity for 13B-class models; a
    model whose int8 weights fit the card keeps int8's per-channel scales
    with ``--load-8bit``."""
    if args.load_4bit and "13b" not in (name or "").lower():
        logger.warning(
            "--load-4bit on %s: int4 is the capacity knob for 13B-class models; a "
            "model whose int8 weights fit the card serves with --load-8bit at int8's "
            "precision (a scale per output channel, not per block of 32 rows).", name)


def load_backend(args: argparse.Namespace, mesh=None):
    """``(backend, model_names)`` for the parsed flags: the checkpoint at
    ``--model-path`` loaded by ``load_pretrained_model`` and served by
    :func:`backend_for`; or the echo backend. With ``mesh`` (a rank of
    ``--tp``; every rank calls this) rank 0 loads the checkpoint and each
    rank keeps its quantized slice (``builder.load_sharded_model``)."""
    check_args(args)
    if args.echo or args.model_path is None:
        return EchoBackend(), [args.model_name or "echo"]
    from llava_plus_torch.mm_utils import get_model_name_from_path
    from llava_plus_torch.models import builder

    name = args.model_name or get_model_name_from_path(args.model_path)
    advise_load_4bit(args, name)
    if mesh is None:
        loaded = builder.load_pretrained_model(args.model_path, args.model_base, name)
        return backend_for(args, loaded), [name]
    from llava_plus_torch.parallel import tp as tp_lib

    group = tp_lib.serving_group(mesh)
    device = _rank_device(args.device, group.rank)
    loaded = builder.load_sharded_model(args.model_path, args.model_base, name, tp=group,
                                        device=device, quantize=_quantize_flag(args))
    return backend_for(args, loaded, mesh=mesh, device=device, quantized=True), [name]


def backend_for(args: argparse.Namespace, loaded, *, mesh=None, device=None,
                quantized: bool = False) -> TorchBackend:
    """The :class:`TorchBackend` of the parsed flags over ``loaded``, the
    ``(tokenizer, params, cfg, image_processor, context_len)`` of
    ``load_pretrained_model``: ``--rope-scaling`` applied to the config, the
    tree moved to ``device`` (default ``--device``) and consumed there by
    ``--load-8bit`` / ``--load-4bit`` unless ``quantized`` says it is
    already; ``mesh`` as :class:`TorchBackend`'s."""
    tokenizer, params, cfg, processor, context_len = loaded
    if args.rope_scaling:
        cfg = _rope_scaled(cfg, args.rope_scaling)
    device = device or args.device
    return TorchBackend(
        tree_map(lambda x: x.to(device), params), cfg, tokenizer, processor,
        device=device, use_engine=not args.no_engine, max_slots=args.max_slots,
        decode_chunk=args.decode_chunk, quantize=None if quantized else _quantize_flag(args),
        kv_int8=args.kv_int8, max_seq_len=args.max_seq_len or context_len,
        paged=args.paged, pool_tokens=args.pool_tokens,
        prefix_cache=not args.no_prefix_cache, speculate=args.speculate,
        spec_chunk=args.spec_chunk, warmup_len=args.warmup,
        stream_interval=args.stream_interval, w8a8=args.w8a8, mesh=mesh)


# ---------------------------------------------------------------------------
# Tensor-parallel ranks (--tp)
# ---------------------------------------------------------------------------

def _rank_device(device: str, rank: int) -> str:
    """Rank ``rank``'s device: ``cuda:<rank>`` for a CUDA ``--device``."""
    return f"cuda:{rank}" if torch.device(device).type == "cuda" else device


def _join_group(args: argparse.Namespace, rank: int, port: int):
    """Join the ``--tp`` ranks' process group (NCCL on the cards, gloo on
    the CPU, with the serving timeout) and return its (1, 1, tp) mesh."""
    import torch.distributed as dist

    from llava_plus_torch.parallel import tp as tp_lib
    from llava_plus_torch.parallel.mesh import make_mesh

    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=args.tp, rank=rank, timeout=tp_lib.DATA_TIMEOUT)
    return make_mesh(1, 1, args.tp, device_type="cuda" if cuda else "cpu")


def _die_with_parent() -> None:
    """Have the kernel kill this process when its parent (rank 0) dies."""
    import ctypes
    import signal

    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _follower_main(argv, rank: int, port: int) -> None:
    """A follower rank of ``--tp``: join the group, take this rank's slice
    of the checkpoint and replay rank 0's device calls until it stops."""
    import torch.distributed as dist

    _die_with_parent()
    args = parse_args(argv)
    mesh = _join_group(args, rank, port)
    backend, _ = load_backend(args, mesh)
    try:
        backend.follow()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_followers(argv, tp: int):
    """Spawn ranks 1 .. tp - 1 of ``--tp`` (each dies with this process);
    returns (their processes, the rendezvous port)."""
    import torch.multiprocessing as mp

    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_follower_main, args=(list(argv), r, port), daemon=True)
             for r in range(1, tp)]
    for proc in procs:
        proc.start()
    return procs, port


def main(argv=None):
    import sys

    from aiohttp import web

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    followers, mesh = [], None
    if args.tp > 1 and not (args.echo or args.model_path is None):
        check_args(args)
        followers, port = start_followers(argv, args.tp)
        mesh = _join_group(args, 0, port)
    backend = None
    try:
        backend, model_names = load_backend(args, mesh)
        worker = ModelWorker(args.controller_address, args.worker_address, backend,
                             model_names, limit_model_concurrency=args.limit_model_concurrency,
                             no_register=args.no_register)
        logger.info(f"args: {args}")
        try:
            web.run_app(build_app(worker), host=args.host, port=args.port)
        finally:
            worker.stop()
    finally:
        if isinstance(backend, TorchBackend):
            backend.stop()
        for proc in followers:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
