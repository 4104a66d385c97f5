"""The port's deployment predictor (``llava_plus_torch/predict.py``) against
the JAX package's (``predict.py``, loaded from its path with importlib), on
the CPU: from one tiny LLaVA-1.5 checkpoint written in ``tmp_path`` (random
weights, seed 0, a word-level tokenizer that names every id), loaded in
f32, both stream the same greedy text (``temperature=0``) piece for piece;
and, as loaded by default (bf16), the port's
pieces are ``Generator.stream``'s on the loaded tree. Without a card the
predictor's default device refuses to load; ``python -m
llava_plus_torch.predict --device cpu`` prints the same answer."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from llava_plus_torch import predict
from llava_plus_torch.mm_utils import process_images
from llava_plus_torch.serve.cli import load_image

from .test_torch_entrypoints import checkpoint  # noqa: F401  (the module fixture)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PROMPT = "What is shown here?"
TOKENS = 12


def _jax_predictor():
    spec = importlib.util.spec_from_file_location("jax_predict", ROOT / "predict.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Predictor()


@pytest.fixture(scope="module")
def port_predictor(checkpoint):  # noqa: F811
    path, _ = checkpoint
    p = predict.Predictor(device="cpu")
    p.setup(str(path))
    return p


def test_predictor_streams_the_jax_predictors_greedy_text(checkpoint, monkeypatch):  # noqa: F811
    """Both predictors load the tree in f32 here (their loaders' default is
    bf16, in which the two packages' logits round apart and a near tie can
    flip a greedy token): the prompt, the image, the stream and its pieces
    are what is compared, at the parity tests' precision."""
    import functools

    from llava_plus_torch.models import builder
    from llava_plus_tpu.models import builder as jax_builder

    for mod in (builder, jax_builder):
        monkeypatch.setattr(mod, "load_pretrained_model",
                            functools.partial(mod.load_pretrained_model, dtype="float32"))
    path, image = checkpoint
    p = predict.Predictor(device="cpu")
    p.setup(str(path))
    assert p.generator.params["language_model"]["embed_tokens"].dtype == torch.float32
    got = list(p.predict(str(image), PROMPT, temperature=0, max_tokens=TOKENS))
    jp = _jax_predictor()
    jp.setup(str(path))
    want = list(jp.predict(str(image), PROMPT, temperature=0, max_tokens=TOKENS))
    assert "".join(got) == "".join(want) and len(got) == TOKENS
    assert got == want


def test_predictor_is_generator_stream_on_the_loaded_tree(checkpoint, port_predictor):  # noqa: F811
    _, image = checkpoint
    p = port_predictor
    pieces = list(p.predict(str(image), PROMPT, temperature=0, max_tokens=TOKENS))
    ids = list(p.generator._last_output_ids)
    text, stop = p.prompt(PROMPT)
    images = process_images([load_image(str(image))], p.image_processor, p.cfg)
    streamed = list(p.generator.stream(text, images=images, max_new_tokens=TOKENS,
                                       temperature=0.0, stop_strings=[stop]))
    assert p.generator._last_output_ids == ids and streamed[-1] == "".join(pieces)
    assert p.generator.params["language_model"]["embed_tokens"].device.type == "cpu"


def test_default_device_is_the_card():
    assert predict.Predictor().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            predict.Predictor().setup("/no/such/checkpoint")


def test_main_on_the_cpu_prints_the_answer(checkpoint, port_predictor):  # noqa: F811
    path, image = checkpoint
    want = "".join(port_predictor.predict(str(image), "hi", temperature=0.2, max_tokens=1024))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-m", "llava_plus_torch.predict", "--weights",
                          str(path), "--image", str(image), "--prompt", "hi", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout == want + "\n"
