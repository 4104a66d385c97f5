"""A serving cell: the worker's per-request entry under seeded traffic.

Requests go to ``TorchBackend.generate_stream`` (``llava_plus_torch.serve.
model_worker``) from client threads in this process, as the worker's
handler threads call it: a base64 PNG, the prompt, greedy decoding, the
drawn ``max_new_tokens``. Each client keeps the host time of every chunk
(one a token). The window opens after the warm-up requests and the mix's
ramp; it closes ``seconds`` later. A traced run then profiles the device for
another ``seconds`` (CUDA activity only) under the same load: the counters and
the host clock are read in the first window, the device's shares in the
second.

- closed loop (``clients`` threads): the next request follows the last one's
  end;
- open loop (``rate``): each request is sent at its due time by a free
  client thread (``clients`` of them), and timed from that due time.

At the close no new request is sent, and every request sent has
``drain_seconds`` to finish; one that did not, raised, or came back with
another number of tokens than its budget has failed. Then the engine stops
and its state is freed, before the reference runs.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import counts, host, measure, port, tokenizer, traffic, weights
from portbench.reference import model as reference


@dataclasses.dataclass
class Record:
    spec: traffic.Spec
    prompt: str
    fused_len: int                    # prompt tokens with the image's patches
    due: float = 0.0                  # host time it was due (open loop) or sent
    sent: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    text: Optional[str] = None
    error: Optional[str] = None
    done: bool = False

    @property
    def ids(self) -> Optional[List[int]]:
        return tokenizer.ids_of_text(self.text or "")

    @property
    def ok(self) -> bool:
        ids = self.ids
        return (self.done and self.error is None and ids is not None
                and len(ids) == self.spec.max_new_tokens)


class Load:
    """The client threads of one run."""

    def __init__(self, backend, mix: dict, specs, prompts, fused, images_b64):
        self.backend = backend
        self.mix = mix
        self.specs = specs
        self.prompts = prompts
        self.fused = fused
        self.images_b64 = images_b64
        self.records: List[Record] = []
        self.lock = threading.Lock()
        self.next = 0
        self.stop = threading.Event()
        self.t_open = None            # open loop: host time of due offset 0
        self.threads: List[threading.Thread] = []

    def _take(self) -> Optional[Record]:
        with self.lock:
            if self.next >= len(self.specs):
                return None
            s = self.specs[self.next]
            self.next += 1
            rec = Record(s, self.prompts[s.index], self.fused[s.index])
            self.records.append(rec)
            return rec

    def _serve(self, rec: Record):
        params = {"prompt": rec.prompt, "images": [self.images_b64[rec.spec.image]],
                  "temperature": 0.0, "top_p": 1.0, "max_new_tokens": rec.spec.max_new_tokens,
                  "stop": None}
        rec.sent = time.perf_counter()
        if not rec.due:
            rec.due = rec.sent
        last = None
        try:
            for last in self.backend.generate_stream(params):
                rec.times.append(time.perf_counter())
            rec.text = (last or "")[len(rec.prompt):]
        except Exception as exc:  # the answer is missing, and counts as failed
            rec.error = repr(exc)
        rec.done = True

    def _closed_client(self):
        while not self.stop.is_set():
            rec = self._take()
            if rec is None:
                return
            self._serve(rec)

    def _open_client(self, q):
        while True:
            rec = q.get()
            if rec is None:
                return
            self._serve(rec)

    def _dispatch(self, q, n_threads):
        while not self.stop.is_set():
            rec = self._take()
            if rec is None:
                break
            rec.due = self.t_open + rec.spec.due
            wait = rec.due - time.perf_counter()
            if wait > 0 and self.stop.wait(wait):
                with self.lock:
                    self.records.remove(rec)
                break
            q.put(rec)
        for _ in range(n_threads):
            q.put(None)

    def start(self):
        if self.mix["loop"] == "closed":
            for _ in range(self.mix["clients"]):
                t = threading.Thread(target=self._closed_client, daemon=True)
                t.start()
                self.threads.append(t)
            return
        import queue

        q = queue.Queue()
        n = self.mix["clients"]
        for _ in range(n):
            t = threading.Thread(target=self._open_client, args=(q,), daemon=True)
            t.start()
            self.threads.append(t)
        self.t_open = time.perf_counter()
        t = threading.Thread(target=self._dispatch, args=(q, n), daemon=True)
        t.start()
        self.threads.append(t)


def _warm(backend, mix, prompts, fused, images_b64, specs, n: int):
    """``n`` requests of the cell's own shapes through the entry, at once,
    with short budgets: the worker's request path and the engine's batch
    sizes at this prompt bucket, before the clock starts. Their records
    count among the run's answers."""
    warm = [dataclasses.replace(s, max_new_tokens=8) for s in specs[:n]]
    load = Load(backend, dict(mix, loop="closed", clients=n), warm, prompts, fused, images_b64)
    load.start()
    for t in load.threads:
        t.join()
    return load.records


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, quantize: Optional[str] = None) -> dict:
    """One run of a serving cell; returns what the metric readers and the
    check read (see ``portbench/run.py``)."""
    tok = tokenizer.for_config(cfg)
    tree = weights.make_tree(cfg, seed, device)
    engine = dict(cell["engine"])
    if quantize:
        engine["quantize"] = quantize
    backend = port.backend(tree, cfg, tok, device, engine)
    del tree

    size = cfg["vision"]["image_size"]
    pix = traffic.images(mix, size, seed)
    images_b64 = [traffic.png_base64(p) for p in pix]
    vocab_words = min(cfg["vocab_size"], 50000)
    rate = mix.get("rate") or cell.get("max_requests_per_s", 20)
    windows = 2 if trace else 1
    n_blocks = int(rate * (windows * seconds + mix["ramp_seconds"] + 30) / mix["block"]) + 2
    specs = traffic.generator(mix)(mix, vocab_words, seed, n_blocks)
    prompts = {s.index: traffic.prompt(cfg["template"], s.question) for s in specs}
    patches = counts.num_patches(cfg)
    fused = {i: len(reference.fused_ids(p, tok, cfg)) - 1 + patches for i, p in prompts.items()}

    warm = _warm(backend, mix, prompts, fused, images_b64, specs, cell.get("warm_requests", 4))
    load = Load(backend, mix, specs, prompts, fused, images_b64)
    load.start()
    time.sleep(mix["ramp_seconds"])

    ttft_log, ttft_stop = [], threading.Event()

    def watch_ttfts():
        seen = backend.engine.prefill_requests
        while not ttft_stop.wait(0.2):
            now = backend.engine.prefill_requests
            ttft_log.extend(port.engine_ttfts(backend, now - seen))
            seen = now

    probe = host.Probe()
    c0 = port.engine_counters(backend)
    watcher = threading.Thread(target=watch_ttfts, daemon=True)
    watcher.start()
    w0 = time.perf_counter()
    time.sleep(seconds)
    w1 = time.perf_counter()
    c1 = port.engine_counters(backend)
    probe.close()
    ttft_stop.set()
    watcher.join()
    traced = None
    if trace:
        # the profiler's own window follows the measured one: what the host
        # clock and the counters read comes from a window it did not slow
        from torch.profiler import ProfilerActivity, profile

        on_card = torch.device(device).type == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        prof.start()
        t0 = time.perf_counter()
        k0 = port.engine_counters(backend)
        time.sleep(seconds)
        if on_card:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        k1 = port.engine_counters(backend)
        prof.stop()
        traced = {"w0": t0, "w1": t1, "counters": {k: k1[k] - k0[k] for k in k0}}
    load.stop.set()
    # every request sent runs to its end (the engine keeps serving): the
    # answers are checked, and the program's state is freed only once no
    # client holds the entry
    deadline = time.perf_counter() + mix.get("drain_seconds", 120)
    for t in load.threads:
        t.join(timeout=max(deadline - time.perf_counter(), 0.0))
    t_drained = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    backend.stop()
    if traced is not None:
        from portbench import trace as trace_mod

        traced.update(trace_mod.reduce(prof, traced["w1"] - traced["w0"]))
        del prof
    with load.lock:
        records = warm + load.records
    t_open = load.t_open
    del backend, load
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    return {
        "setup_s": w0 - t_start, "window_s": w1 - w0, "w0": w0, "w1": w1,
        "records": records, "t_open": t_open, "t_drained": t_drained,
        "counters": {k: c1[k] - c0[k] for k in c0}, "engine_ttfts": ttft_log,
        "host": probe.summary(), "trace": traced, "memory_peak_bytes": peak,
        "pixels": pix, "tokenizer": tok,
    }


def check(cell: dict, cfg: dict, seed: int, out: dict, device) -> dict:
    """The served tokens of a sample of finished answers against the
    reference: the widest gap by which a served token's reference logit lies
    below the reference's best at its position. The sample, drawn from the
    seed, always holds the answer with the most tokens."""
    done = [r for r in out["records"] if r.ok]
    failed = [r for r in out["records"] if not r.ok]
    n = min(cell["check"]["answers"], len(done))
    gap = None
    tokens = 0
    if n:
        rng = np.random.default_rng([int(seed), 11])
        longest = max(range(len(done)), key=lambda i: (len(done[i].ids), -i))
        rest = [i for i in range(len(done)) if i != longest]
        pick = [longest] + [rest[i] for i in rng.choice(len(rest), size=n - 1, replace=False)]
        reference.precise()
        tree = weights.make_tree(cfg, seed, device)
        tok = out["tokenizer"]
        seqs, imgs, rows, served = [], [], [], []
        for i in pick:
            r = done[i]
            ids = reference.fused_ids(r.prompt, tok, cfg)
            fused = len(ids) - 1 + counts.num_patches(cfg)
            out_ids = r.ids
            seqs.append(ids + out_ids[:-1])
            imgs.append(torch.from_numpy(out["pixels"][r.spec.image]).to(device))
            rows.append(slice(fused - 1, fused - 1 + len(out_ids)))
            served.append(out_ids)
        with torch.no_grad():
            logits = reference.logits(tree, cfg, seqs, imgs, rows)
        gaps = []
        for lg, ids in zip(logits, served):
            chosen = lg.gather(1, torch.tensor(ids, device=lg.device)[:, None])[:, 0]
            gaps.append((lg.max(dim=1).values - chosen).max().item())
            tokens += len(ids)
        gap = max(gaps)
        del tree, logits
    limit = cell["check"]["served_logit_gap"]
    return {
        "failed": len(failed),
        "attempted": len(out["records"]),
        "checks": {
            "served_logit_gap": {"value": gap, "limit": limit},
            "failed_answers": {"value": len(failed), "limit": 0},
            "answers_checked": {"value": n, "limit": 1},
            "tokens_checked": {"value": tokens, "limit": 1},
        },
        "correct": bool(n and gap is not None and gap <= limit and not failed),
    }


def load_summary(out: dict) -> dict:
    """How the load went: requests offered and finished per second of the
    window, how late the open loop's sends ran (p95, ms), output tokens a
    second in each quarter of the window, the host ms a decode step took in
    the window and (traced) in the profiled one, and what the host gave."""
    w0, w1 = out["w0"], out["w1"]
    win = w1 - w0
    sent = [r for r in out["records"] if w0 <= r.due < w1]
    ended = [r for r in out["records"] if r.done and r.times and w0 <= r.times[-1] < w1]
    late = [r.sent - r.due for r in sent if r.sent]
    quarters = [0] * 4
    for r in out["records"]:
        for t in r.times:
            if w0 <= t < w1:
                quarters[int(4 * (t - w0) / win)] += 1
    steps = out["counters"]["decode_steps"]
    summary = {"offered_per_s": len(sent) / win, "finished_per_s": len(ended) / win,
               "late_p95_ms": 1e3 * measure.quantile(late, 0.95) if late else None,
               "in_flight_at_close": sum(1 for r in out["records"] if r.sent and r.sent < w1
                                         and not (r.times and r.times[-1] < w1)),
               "tokens_per_s_by_quarter": [4 * q / win for q in quarters],
               "step_ms": 1e3 * win / steps if steps else None}
    t = out["trace"]
    if t:
        steps = t["counters"]["decode_steps"]
        summary["traced_step_ms"] = 1e3 * t["window_s"] / steps if steps else None
    summary.update(out["host"])
    return summary
