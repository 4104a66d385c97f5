"""The plain reference against the port at the tiny configurations, on the
CPU: the same float32 weights (the port quantizes its copy to int8 as its
``--load-8bit`` does), the same prompt and image, logits at every position."""

import numpy as np
import pytest
import torch
from PIL import Image

from portbench import port, tokenizer, traffic, weights
from portbench.reference import model as reference
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["tiny-mpt", "tiny-llama"])
def test_reference_matches_the_port(name):
    from llava_plus_torch.generate import batch_to_device, multimodal_arrays
    from llava_plus_torch.models import llava
    from llava_plus_torch.ops.quant import quantize_llava_params

    cfg = tiny.CONFIGS[name]
    tok = tokenizer.for_config(cfg)
    pcfg = port.llava_config(cfg)
    mix = dict(tiny.MIX)
    spec = traffic.requests(mix, 500, seed=5, n_blocks=1)[0]
    prompt = traffic.prompt(cfg["template"], spec.question)
    pixels = traffic.images(mix, cfg["vision"]["image_size"], seed=5)[0]

    # the worker's request path: image start / end tokens, the processor
    served = prompt
    if cfg["mm_use_im_start_end"]:
        served = prompt.replace("<image>", "<im_start><image><im_end>")
    image = port.image_processor(cfg)(Image.fromarray(pixels))
    arrays, plan = multimodal_arrays(pcfg, tok, [served], [image[None]], max_seq_len=256,
                                     prefill_bucket=1)
    tree = weights.make_tree(cfg, 9, "cpu", dtype=torch.float32)
    params = quantize_llava_params(tree, pcfg.language_model_type, bits=8, fuse=True)
    with torch.no_grad():
        got, _ = llava.forward(params, pcfg, batch_to_device(arrays, "cpu"))
    n = int(plan.lengths[0])

    ids = reference.fused_ids(prompt, tok, cfg)
    assert len(ids) - 1 + (cfg["vision"]["image_size"] // 14) ** 2 == n
    with torch.no_grad():
        want = reference.logits(weights.make_tree(cfg, 9, "cpu", dtype=torch.float32), cfg,
                                [ids], [torch.from_numpy(pixels)], [slice(0, n)])[0]
    # the same float32 arithmetic in another order: within f32 rounding
    np.testing.assert_allclose(got[0, :n].numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_int8_values_round_trip():
    w = torch.tensor([[1.0, -0.5], [-2.0, 0.25], [0.5, 0.0]])
    q = reference.int8_values(w)
    scale = torch.tensor([2.0, 0.5]) / 127
    np.testing.assert_allclose(q.numpy(), (torch.round(w / scale).clamp(-127, 127) * scale).numpy())
    assert q[1, 0] == -2.0 and q[0, 1] == -0.5


def test_fused_ids_put_one_image_entry_and_one_bos():
    cfg = tiny.CONFIGS["tiny-llama"]
    tok = tokenizer.for_config(cfg)
    ids = reference.fused_ids("[INST] <image> w7 w8 [/INST]", tok, cfg)
    assert ids == [1, 5, reference.IMAGE, 7, 8, 6]
    mpt = tiny.CONFIGS["tiny-mpt"]
    ids = reference.fused_ids("w9 <image> w10", tokenizer.for_config(mpt), mpt)
    assert ids == [9, 502, reference.IMAGE, 503, 10]
