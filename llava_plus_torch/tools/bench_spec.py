"""Prompt-lookup speculative decoding of the port on one card: the port's
counterpart of ``tools/bench_spec.py``.

LLaVA-1.5-7B at full width and depth with random bf16 weights (seed 0),
quantized to int8 and fused, an int8 KV cache of 2048 slots:

  run      one greedy stream (a 160-word repetitive prompt and an image, 128
           new tokens) on an engine of one slot, speculation off and then on
           (k proposals a step, ``--chunk`` steps a dispatch), after a warm
           request of 8 tokens on each engine: tokens/s, the acceptance
           (tokens a verify step delivered) and the speculative loop's host
           seconds by part (``spec_timers``);
  isolate  the engine loop stopped, every slot active at ``--fill``: one
           plain decode step ending with its fetch, a plain chunk of
           ``--chunk`` steps and its fetch (per step), one verify step
           ending with the fetch of its row, a chunk of ``--chunk`` verify
           steps and its fetch (per step), and the fetch of a few bytes
           alone; host ms, means after 3 warm-ups.

With random weights the acceptance depends on whether the greedy chain
happens to repeat itself; what the numbers show is whether a verify step of
k + 1 tokens costs about one plain step, and whether accepted tokens raise
tokens/s in proportion.

Usage: python -m llava_plus_torch.tools.bench_spec [--spec 4] [--new 128] [--chunk 4]
       [--isolate [--slots 16] [--fill 512]] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.models import llava as llava_model
from llava_plus_torch.models.configs import LLAVA_15_7B
from llava_plus_torch.ops.quant import quantize_llava_params
from llava_plus_torch.serve.engine import BatchedEngine, Request, _to_host
from llava_plus_torch.tools import common

CFG = LLAVA_15_7B
PROMPT = "<image>\n" + " ".join(f"w{i % 24}" for i in range(160))


def make_params(device: str, cfg=CFG):
    """The tree of ``cfg`` (LLaVA-1.5-7B by default), random bf16 from seed 0
    on ``device``, with the language model quantized to int8 and fused."""
    params = llava_model.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    return quantize_llava_params(params, cfg.language_model_type, bits=8, fuse=True)


def make_engine(params, speculate: int, spec_chunk: int = 4, *, max_slots: int = 1,
                tokenizer=None, cfg=CFG) -> BatchedEngine:
    return BatchedEngine(params, cfg, tokenizer or DebugTokenizer(vocab_size=cfg.text.vocab_size),
                         max_slots=max_slots, max_seq_len=2048, prefill_bucket=256,
                         cache_dtype=torch.int8, speculate=speculate, spec_chunk=spec_chunk)


def _image(rng):
    size = CFG.vision.image_size
    return rng.standard_normal((1, size, size, 3)).astype(np.float32)


def _drain(req: Request) -> int:
    """Chunks (one per emitted token) until the request's end."""
    n = 0
    while req._chunks.get(timeout=900) is not None:
        n += 1
    return n


def run(speculate: int, new_tokens: int = 128, spec_chunk: int = 4, *, params,
        tokenizer=None, cfg=CFG) -> dict:
    """One greedy stream of ``new_tokens`` after a warm request, on an
    engine of one slot (``params`` of ``cfg``)."""
    rng = np.random.default_rng(0)
    eng = make_engine(params, speculate, spec_chunk, tokenizer=tokenizer, cfg=cfg)
    try:
        _drain(eng.submit(Request(prompt=PROMPT, images=_image(rng), max_new_tokens=8)))
        steps0, emitted0 = eng.spec_steps, eng.spec_emitted
        eng.spec_timers = dict.fromkeys(eng.spec_timers, 0)
        req = Request(prompt=PROMPT, images=_image(rng), max_new_tokens=new_tokens)
        t0 = time.perf_counter()
        n = _drain(eng.submit(req))
        dt = time.perf_counter() - t0
        steps = eng.spec_steps - steps0
        return {"mode": speculate, "tokens": n, "seconds": dt, "tok_s": n / dt,
                "ttft_s": req.ttft, "steps": steps,
                "acceptance": (eng.spec_emitted - emitted0) / steps if steps else 0.0,
                "timers": dict(eng.spec_timers), "refreshes": eng.spec_refreshes,
                "pauses": eng.spec_pauses}
    finally:
        eng.stop()


def step_fns(eng: BatchedEngine, fill: int):
    """With the engine's loop stopped and every slot active at position
    ``fill``: closures of a plain decode chunk of n steps (``plain(n=...)``,
    one by default) and of a verify chunk of m steps (``verify(m)``), each
    ending with the fetch of its tokens, as the
    engine's loop fetches them (with ``fetch=False`` they only queue the
    work and the copy). The verify state advances by what it accepts, so
    call it a few dozen times at most."""
    B, dev = eng.max_slots, eng.device
    positions = torch.full((B,), fill, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    temps, tops = torch.zeros(B, device=dev), torch.ones(B, device=dev)
    seeds = torch.zeros(B, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(1)
    hist = np.zeros((B, eng.max_seq_len + 1), np.int64)
    hist[:, :fill + 1] = rng.integers(8, min(1000, eng.lm_cfg.vocab_size), size=(B, fill + 1))
    st = eng._spec_state(hlen=np.full(B, fill + 1, np.int64), hist=hist,
                         cur=hist[:, fill].copy(), budget=np.full(B, 1 << 30, np.int64),
                         active=active, seeds=seeds, temps=temps, tops=tops,
                         any_sampled=False)

    def plain(fetch: bool = True, n: int = 1):
        toks, eng.tokens = eng._decode_n(positions, active, temps, tops, seeds, False, n)
        return toks.tolist() if fetch else toks

    def verify(m: int = 1, fetch: bool = True):
        host, event = _to_host(eng._spec_step(st, m))
        if fetch and event is not None:
            event.synchronize()
        return host

    return plain, verify


def _host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def isolate(speculate: int = 4, spec_chunk: int = 4, *, params, slots: int = 1,
            fill: int = 512) -> dict:
    """Host ms of a plain step, a verify step and a verify chunk (per
    step), each with its fetch, and of a fetch alone."""
    rng = np.random.default_rng(0)
    eng = make_engine(params, speculate, spec_chunk, max_slots=slots)
    try:
        _drain(eng.submit(Request(prompt=PROMPT, images=_image(rng), max_new_tokens=8)))
    finally:
        eng.stop()   # the loop stops; the engine's programs are ours
    with torch.inference_mode():
        plain, verify = step_fns(eng, fill)
        one = torch.zeros(4, dtype=torch.int32, device=eng.device)
        return {"plain_step_ms": _host_ms(plain),
                f"plain_chunk{spec_chunk}_per_step_ms":
                    _host_ms(lambda: plain(n=spec_chunk), iters=5) / spec_chunk,
                "verify_step_ms": _host_ms(verify, iters=10),
                f"verify_chunk{spec_chunk}_per_step_ms":
                    _host_ms(lambda: verify(spec_chunk), iters=5) / spec_chunk,
                "fetch_ms": _host_ms(lambda: one.tolist())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spec", type=int, default=4, help="proposals verified a step")
    p.add_argument("--new", type=int, default=128, help="tokens of the timed stream")
    p.add_argument("--chunk", type=int, default=4, help="verify steps a dispatch")
    p.add_argument("--isolate", action="store_true", help="time the steps apart")
    p.add_argument("--slots", type=int, default=1, help="active slots (--isolate)")
    p.add_argument("--fill", type=int, default=512, help="their position (--isolate)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(common.describe_device(args.device), flush=True)
    params = make_params(args.device)
    if args.isolate:
        res = isolate(args.spec, args.chunk, params=params, slots=args.slots, fill=args.fill)
        for name, ms in res.items():
            print(f"  {name:28s} {ms:9.3f} ms", flush=True)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    results = {}
    for mode in (0, args.spec):
        r = run(mode, args.new, args.chunk, params=params)
        print(f"  spec={mode}: {r['tokens']} tokens in {r['seconds']:.2f} s = "
              f"{r['tok_s']:.1f} tok/s (acceptance {r['acceptance']:.2f})", flush=True)
        if mode:
            print(f"  spec loop breakdown: {dict(r['timers'], steps=r['steps'], refreshes=r['refreshes'])}",
                  flush=True)
        results["plain" if mode == 0 else f"spec{mode}"] = r
    plain, spec = results["plain"], results[f"spec{args.spec}"]
    print("RESULT " + json.dumps({"plain_tok_s": plain["tok_s"], "spec_tok_s": spec["tok_s"],
                                  "acceptance": spec["acceptance"],
                                  "speedup": spec["tok_s"] / plain["tok_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
