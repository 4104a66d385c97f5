"""The one traffic generator: a mix is a data file (``portbench/traffic/<mix>.json``).

A mix fixes the *set* of request shapes, drawn once from its own
``set_seed``: a block of ``block`` requests (question length, output budget,
inter-arrival gap). Every block holds that same set; the run's ``--seed``
only orders each block and picks the words and images. So every seed, and
every prefix of whole blocks, asks for the same work.

Distributions (``{"dist": ...}``):

- ``uniform_int``: ``lo`` .. ``hi`` inclusive;
- ``lognormal``: median ``median``, log-sd ``sigma``, clipped to ``lo`` .. ``hi``,
  rounded;
- ``const``: ``value``;
- ``gamma`` (gaps only): mean 1, coefficient of variation ``cv``; scaled by
  the mix's ``rate`` (requests/s).

A mix that needs another generator names it, ``"generator": "<name>"``:
``generators/<name>.py`` with a ``requests`` of the same signature.

A mix's fields: ``loop`` (``closed`` with ``clients`` threads, or ``open``
at ``rate``), ``block``, ``set_seed``, ``question_tokens``, ``output_tokens``,
``arrivals`` (open loop), ``images`` (distinct images a run draws from),
``ramp_seconds`` (load before the window opens) and ``drain_seconds`` (how
long an open loop waits, after the window, for the requests due in it).
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
from pathlib import Path
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent
WORD_LO = 32  # question words are w32 .. w<vocab_words - 1>


def load_mix(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def generator(mix: dict, root: Path = HERE):
    """The mix's generator: ``requests`` of ``generators/<name>.py`` where the
    mix names one under ``"generator"``, else this module's."""
    name = mix.get("generator")
    if name is None:
        return requests
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "portbench_generator_" + name, root / "generators" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.requests


@dataclasses.dataclass
class Spec:
    """One request as the client sends it."""

    index: int
    question: List[int]      # word ids
    max_new_tokens: int
    image: int               # index into the run's images
    due: float = 0.0         # open loop: seconds after the window opens


def _draw(d: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    kind = d["dist"]
    if kind == "const":
        return np.full(n, d["value"])
    if kind == "uniform_int":
        return rng.integers(d["lo"], d["hi"] + 1, size=n)
    if kind == "lognormal":
        x = np.exp(np.log(d["median"]) + d["sigma"] * rng.standard_normal(n))
        return np.clip(np.rint(x), d["lo"], d["hi"]).astype(np.int64)
    if kind == "gamma":
        shape = 1.0 / d["cv"] ** 2
        return rng.gamma(shape, 1.0 / shape, size=n)
    raise ValueError(f"unknown distribution {kind!r}")


def shape_set(mix: dict) -> dict:
    """The block's request shapes, the same for every seed."""
    rng = np.random.default_rng(mix["set_seed"])
    n = mix["block"]
    out = {"question": _draw(mix["question_tokens"], rng, n).astype(np.int64),
           "output": _draw(mix["output_tokens"], rng, n).astype(np.int64)}
    if mix["loop"] == "open":
        out["gap"] = _draw(mix["arrivals"], rng, n) / float(mix["rate"])
    return out


def requests(mix: dict, vocab_words: int, seed: int, n_blocks: int) -> List[Spec]:
    """``n_blocks`` blocks of requests for ``seed``."""
    shapes = shape_set(mix)
    rng = np.random.default_rng(int(seed))
    n = mix["block"]
    specs, t = [], 0.0
    for b in range(n_blocks):
        order = rng.permutation(n)
        gaps = shapes["gap"][rng.permutation(n)] if "gap" in shapes else np.zeros(n)
        for j in range(n):
            i = int(order[j])
            q = rng.integers(WORD_LO, vocab_words, size=int(shapes["question"][i]))
            specs.append(Spec(index=b * n + j, question=[int(x) for x in q],
                              max_new_tokens=int(shapes["output"][i]),
                              image=int(rng.integers(0, mix["images"])), due=t))
            t += float(gaps[j])
    return specs


def images(mix: dict, size: int, seed: int) -> List[np.ndarray]:
    """``mix["images"]`` smooth RGB images [size, size, 3] uint8: coarse
    noise upsampled by 8 (a photo-like PNG, not incompressible noise)."""
    rng = np.random.default_rng([int(seed), 7])
    out = []
    for _ in range(mix["images"]):
        coarse = rng.integers(0, 256, size=(-(-size // 8), -(-size // 8), 3), dtype=np.uint8)
        out.append(np.ascontiguousarray(coarse.repeat(8, 0).repeat(8, 1)[:size, :size]))
    return out


def png_base64(pixels: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def prompt(template: str, question: List[int]) -> str:
    return template.replace("{question}", " ".join(f"w{i}" for i in question))
