"""Tensor-parallel serving on the port (``llava_plus_torch/parallel/tp.py``,
``BatchedEngine(mesh=)``, ``Generator(mesh=)``) against the JAX package's
``mesh=make_mesh(1, 1, 2)`` engine and Generator, on the CPU.

In this process: the shard plan at LLaMA-7B's and LLaVA-MPT-7B's shapes on
meta tensors (section splits of the fused matrices, the FFN's 128-row
units), on small real trees (the shards reassemble to the whole tree; a
row-parallel int8 matrix keeps the whole matrix's scales), the local ALiBi
slopes, the shapes that do not split, and the W8A8 quantize with a given
row amax against JAX's row-parallel ``_w8a8_matmul`` under a 2-device mesh
(conftest gives JAX 8 CPU devices).

Then ONE launch of 2 gloo ranks (a file store in ``tmp_path``), JAX-free
child processes, serves the tiny LLaMA and MPT at tp = 2: dense and paged
caches, f32 and int8 weights, f32 and int8 KV, the Generator (streams and
beam search), speculation and W8A8. Rank 0 records first-token logits and
greedy streams, which this process holds to JAX's mesh engine and
Generator (logits at the f32 tolerance of ``tests/test_torch_llava.py``,
streams exactly) and, for speculation and W8A8, to the port's one-rank
engine; every rank records what each op returned and the replicated state
it ends with, which must be equal across ranks.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.generate import Generator as JaxGenerator
from llava_plus_tpu.generate import prepare_multimodal_request as jax_prepare
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt_config
from llava_plus_tpu.ops import quant as jax_quant
from llava_plus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch.models import mpt
from llava_plus_torch.models.configs import (
    LLAVA_15_7B, LLAVA_MPT_7B, tiny_llava_config, tiny_llava_mpt_config,
)
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import quant, w8a8
from llava_plus_torch.parallel import tp

from .test_generate import CharTokenizer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-4)   # tests/test_torch_llava.py's f32 tolerance
PROMPTS = ["hello", "the cat sat on the mat"]
NEW = 8

# ---------------------------------------------------------------------------
# The shard plan, in this process
# ---------------------------------------------------------------------------


def _meta_tree(cfg, quantized):
    """A LLaVA language model tree of ``cfg``'s shapes on the meta device,
    fused as ``quantize_llava_params(..., fuse=True)`` leaves it."""
    def w(*shape):
        if not quantized:
            return torch.empty(shape, device="meta", dtype=torch.bfloat16)
        return {quant.QKEY: torch.empty(shape, device="meta", dtype=torch.int8),
                quant.SKEY: torch.empty(shape[:-2] + (1, shape[-1]), device="meta")}

    if cfg.language_model_type == "mpt":
        c = cfg.mpt
        D, L, F = c.d_model, c.n_layers, c.expansion_ratio * c.d_model
        return {"layers": {"attn": {"wqkv": w(L, D, 3 * D), "out_proj": w(L, D, D)},
                           "mlp": {"up_proj": w(L, D, F), "down_proj": w(L, F, D)}}}
    c = cfg.text
    D, L, F, V = c.hidden_size, c.num_hidden_layers, c.intermediate_size, c.vocab_size
    return {"lm_head": w(D, V),
            "layers": {"attn": {"wqkv": w(L, D, 3 * D), "wo": w(L, D, D)},
                       "mlp": {"w_gateup": w(L, D, 2 * F), "w_down": w(L, F, D)}}}


@pytest.mark.parametrize("quantized", [False, True])
def test_shard_plan_at_7b_shapes(quantized):
    """LLaMA-7B over 4: heads 8 a rank, the FFN's 86 units of 128 as 22, 22,
    21, 21 (2816, 2816, 2688, 2688: each K % 128 == 0 for the kernels), the
    vocab 8000 a rank; LLaVA-MPT-7B's 16384 over 4 evenly."""
    assert tp.ffn_split(11008, 4) == [2816, 2816, 2688, 2688]
    assert tp.ffn_split(11008, 2) == [5504, 5504]
    assert tp.ffn_split(16384, 4) == [4096] * 4
    assert tp.ffn_split(128, 2) == [64, 64]   # narrow test models: even
    lm = _meta_tree(LLAVA_15_7B, quantized)
    key = quant.QKEY if quantized else None

    def shape(x):
        return tuple((x[key] if key else x).shape)

    for r, f in enumerate([2816, 2816, 2688, 2688]):
        plan = tp.shard_plan(LLAVA_15_7B, r, 4)
        got = {n: shape(tp.shard_leaf(path, _get(lm, path), plan))
               for n, path in (("wqkv", ("layers", "attn", "wqkv")),
                               ("wo", ("layers", "attn", "wo")),
                               ("gateup", ("layers", "mlp", "w_gateup")),
                               ("down", ("layers", "mlp", "w_down")),
                               ("head", ("lm_head",)))}
        assert got == {"wqkv": (32, 4096, 3 * 1024), "wo": (32, 1024, 4096),
                       "gateup": (32, 4096, 2 * f), "down": (32, f, 4096),
                       "head": (4096, 8000)}
        if quantized:   # row-parallel int8: the whole matrix's scales
            down = tp.shard_leaf(("layers", "mlp", "w_down"), lm["layers"]["mlp"]["w_down"], plan)
            assert tuple(down[quant.SKEY].shape) == (32, 1, 4096)
    mlm = _meta_tree(LLAVA_MPT_7B, quantized)
    plan = tp.shard_plan(LLAVA_MPT_7B, 3, 4)
    assert shape(tp.shard_leaf(("layers", "mlp", "down_proj"),
                               mlm["layers"]["mlp"]["down_proj"], plan)) == (32, 4096, 4096)
    assert shape(tp.shard_leaf(("layers", "attn", "wqkv"),
                               mlm["layers"]["attn"]["wqkv"], plan)) == (32, 4096, 3072)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tiny(kind, kv_heads=2):
    if kind == "mpt":
        return tiny_llava_mpt_config()
    cfg = tiny_llava_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             num_key_value_heads=kv_heads))


def _tree(cfg, bits, fuse):
    from llava_plus_torch.models import llava

    params = llava.init_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    if bits:
        params = quant.quantize_llava_params(params, cfg.language_model_type, bits=bits,
                                             fuse=fuse)
    elif fuse and cfg.language_model_type == "llama":
        quant.fuse_llama_matrices(params["language_model"])
    return params


def _dense(w):
    return quant.dequantize_array(w, torch.float32) if quant.is_quantized(w) else w


@pytest.mark.parametrize("kind, bits, fuse, size", [
    ("llama", None, True, 2), ("llama", 8, True, 4), ("llama", 4, False, 2),
    ("mpt", None, False, 2), ("mpt", 8, False, 4), ("mpt", 4, False, 2)])
def test_shards_reassemble_to_the_tree(kind, bits, fuse, size):
    """Each split leaf's shards, laid side by side by section (columns) or
    stacked (rows), give the whole leaf back: fused ``wqkv`` / ``w_gateup``
    as ``[q_0 | k_0 | v_0 | q_1 | ...]``, never a contiguous run of fused
    columns. A row-parallel int8 leaf's scale is the whole matrix's, so its
    shards dequantize to the whole matrix's rows."""
    cfg = _tiny(kind, kv_heads=4)
    params = _tree(cfg, bits, fuse)
    shards = [tp.shard_for_serving(params, cfg, r, size) for r in range(size)]
    plan = tp.shard_plan(cfg, 0, size)
    for path, (axis, _) in plan.items():
        whole = _get(params["language_model"], path) if _has(params["language_model"], path) \
            else None
        if whole is None:
            continue
        parts = [_dense(_get(s["language_model"], path)) for s in shards]
        full = _dense(whole)
        if axis == "rows":
            assert torch.equal(torch.cat(parts, dim=-2), full), path
            if bits == 8:
                for s in shards:
                    assert torch.equal(_get(s["language_model"], path)[quant.SKEY],
                                       whole[quant.SKEY])
            continue
        sections = {"wqkv": 3, "w_gateup": 2}.get(path[-1], 1)
        chunks = [p.chunk(sections, dim=-1) if path[-1] != "wqkv" else None for p in parts]
        if path[-1] == "wqkv":
            c = cfg.mpt if kind == "mpt" else cfg.text
            H = c.n_heads if kind == "mpt" else c.num_attention_heads
            Hkv = c.kv_heads if kind == "mpt" else c.num_key_value_heads
            Dh = c.head_dim
            widths = [H * Dh // size, Hkv * Dh // size, Hkv * Dh // size]
            chunks = [p.split(widths, dim=-1) for p in parts]
        rebuilt = torch.cat([torch.cat([ch[i] for ch in chunks], dim=-1)
                             for i in range(sections)], dim=-1)
        assert torch.equal(rebuilt, full), path
    # untouched leaves are the caller's own
    assert shards[1]["vision_tower"] is params["vision_tower"]
    emb = "wte" if kind == "mpt" else "embed_tokens"
    assert shards[1]["language_model"][emb] is params["language_model"][emb]
    # a tree already cut is left as it is
    assert tp.shard_for_serving(shards[1], cfg, 1, size) is shards[1]


def _has(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


def test_local_alibi_slopes_are_the_global_slice():
    """Rank r's slopes are ``alibi_slopes(H)[r * H / tp:(r + 1) * H / tp]``,
    not ``alibi_slopes(H / tp)``; 12 heads (not a power of two) too."""
    for H, size in ((32, 4), (4, 2), (12, 2)):
        whole = mpt.alibi_slopes(H)
        parts = [mpt._device_slopes(H, 8, torch.device("cpu"), r, size) for r in range(size)]
        assert torch.equal(torch.cat(parts), whole)
        assert not torch.equal(parts[1], mpt.alibi_slopes(H // size))


def test_shapes_that_do_not_split_raise():
    mqa = dataclasses.replace(LLAVA_MPT_7B, mpt=dataclasses.replace(LLAVA_MPT_7B.mpt,
                                                                    multiquery=True))
    with pytest.raises(ValueError, match="kv heads do not split over tp = 2"):
        tp.shard_plan(mqa, 0, 2)
    gqa = _tiny("llama", kv_heads=2)
    with pytest.raises(ValueError, match="kv heads do not split over tp = 4"):
        tp.shard_plan(gqa, 0, 4)
    odd = dataclasses.replace(gqa, text=dataclasses.replace(gqa.text, vocab_size=511))
    with pytest.raises(ValueError, match="vocab of 511"):
        tp.shard_plan(odd, 0, 2)
    qk = dataclasses.replace(LLAVA_MPT_7B, mpt=dataclasses.replace(LLAVA_MPT_7B.mpt,
                                                                   qk_ln=True))
    with pytest.raises(ValueError, match="qk LayerNorm"):
        tp.shard_plan(qk, 0, 2)
    assert tp.local_heads(32, size=4) == 8


# ---------------------------------------------------------------------------
# W8A8 with a given row amax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_given_amax_plain_version(dtype):
    """Given each row's absmax over the whole K, a slice of the row is
    quantized exactly as the whole row is; the given amax is floored as the
    computed one is."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32)).to(dtype)
    x[2] = 0
    xq, scale = w8a8.quantize_rows_reference(x)
    amax = x.abs().amax(dim=-1)
    for lo, hi in ((0, 32), (32, 64)):
        pq, ps = w8a8.w8a8_quantize_rows(x[:, lo:hi].contiguous(), amax)
        assert torch.equal(pq, xq[:, lo:hi]) and torch.equal(ps, scale)
    assert torch.equal(w8a8.quantize_rows_reference(x, amax)[0], xq)


def test_w8a8_row_parallel_matches_jax_under_a_mesh():
    """JAX's ``_w8a8_matmul`` with x and the int8 weight split over K on a
    (1, 1, 2) mesh (GSPMD reduces the row absmax and the int32 sums) equals
    the port's row-parallel product on each half's shards: every rank
    quantizes its slice by the whole row's absmax (the given amax), and the
    int32 sums add up to the whole product's, bit for bit in f32."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 64)) * 0.05).astype(np.float32)
    qw = jax_quant.quantize_array(jnp.asarray(w))
    mesh = jax_make_mesh(1, 1, 2)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "tp")))
    qs = jax.device_put(qw[jax_quant.QKEY], NamedSharding(mesh, P("tp", None)))
    # op by op, as tests/test_torch_w8a8.py holds the unsharded function (XLA
    # compiles the row scale's division into a multiply)
    want = np.asarray(jax_quant._w8a8_matmul(xs, qs, qw[jax_quant.SKEY]))
    np.testing.assert_array_equal(
        want, np.asarray(jax_quant._w8a8_matmul(jnp.asarray(x), qw[jax_quant.QKEY],
                                                qw[jax_quant.SKEY])))
    tq = torch.from_numpy(np.array(qw[jax_quant.QKEY]))
    ts = torch.from_numpy(np.array(qw[jax_quant.SKEY]))
    tx = torch.from_numpy(x)
    amax = tx.abs().amax(dim=-1)
    accs, rs = [], None
    for lo, hi in ((0, 64), (64, 128)):
        xq, rs = w8a8.w8a8_quantize_rows(tx[:, lo:hi].contiguous(), amax)
        accs.append(w8a8.w8a8_int_mm(xq, tq[lo:hi]))
    got = w8a8.w8a8_epilogue(accs[0] + accs[1], rs, ts, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    whole = w8a8.w8a8_product(tx, tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(got, whole)


# ---------------------------------------------------------------------------
# 2 gloo ranks serving at tp = 2
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import pickle, sys
import numpy as np, torch, torch.distributed as dist

torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank, world_size=world)
from torch.distributed.tensor import DTensor
from llava_plus_torch.generate import Generator, multimodal_arrays
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import w8a8
from llava_plus_torch.parallel.mesh import make_mesh
from llava_plus_torch.serve.engine import BatchedEngine, Request

class CharTokenizer:  # tests/test_generate.py's, without its JAX imports
    bos_token_id, eos_token_id = 1, 2
    def __call__(self, text):
        return type("Enc", (), {"input_ids": [1] + [min(ord(c) + 3, 500) for c in text]})()
    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) for i in ids if i > 2)

with open(f"{d}/in.pkl", "rb") as f:
    inp = pickle.load(f)
# row-parallel W8A8 quantizes by the given (all-reduced) row amax
given = [0]
_quantize_rows = w8a8.w8a8_quantize_rows
def counted(x, amax=None):
    given[0] += amax is not None
    return _quantize_rows(x, amax)
w8a8.w8a8_quantize_rows = counted
tok = CharTokenizer()
mesh = make_mesh(1, 1, world, device_type="cpu")
out = {"ops": {}, "state": {}, "leaves": {}, "logits": {}, "streams": {}, "ref": {},
       "followed": {}}
DUMP = ("prefill", "decode", "spec_step", "suffix")


def record(eng, name):
    # every rank keeps what these ops returned (its tokens)
    rec = out["ops"].setdefault(name, [])
    for op in DUMP:
        orig = getattr(eng, "_op_" + op)
        def wrapped(*a, _orig=orig, _op=op):
            res = _orig(*a)
            t = res[1] if _op == "prefill" else res
            rec.append((_op, t.numpy().copy()))
            return res
        setattr(eng, "_op_" + op, wrapped)


def state(eng):
    c = eng.cache
    keys = ("seg_buf", "page_table", "alloc") if eng.paged else ("seg",)
    st = {k: getattr(c, k).numpy().copy() for k in keys}
    st["tokens"] = eng.tokens.numpy().copy()
    if eng._spec_dev is not None:
        st["hist"] = eng._spec_dev["hist"].numpy().copy()
    return st


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def first_logits(eng, cfg, prompts, images):
    arrays, plan = multimodal_arrays(cfg, tok, prompts, images, max_seq_len=eng.max_seq_len,
                                     prefill_bucket=eng.prefill_bucket)
    n = len(prompts)
    _, _, logits = eng._issue("prefill", next(eng._pids), list(eng._caches.keys()), arrays,
                              [0.0] * n, [1.0] * n, [0] * n, [0] * n)
    return logits.numpy().copy()


def request(r):
    r = dict(r)
    if r.pop("image", False):
        r["images"] = inp["image"]
    return Request(**r)


def serve(name, case):
    cfg = LlavaConfig.from_json(inp["cfg"][case["kind"]])
    tree = inp["trees"][case["tree"]]
    kw = dict(case["kw"])
    kw["cache_dtype"] = getattr(torch, kw["cache_dtype"])
    eng = BatchedEngine(from_numpy(tree, "cpu"), cfg, tok, mesh=mesh, **kw)
    record(eng, name)
    out["leaves"][name] = (all(type(x) is torch.Tensor and not isinstance(x, DTensor)
                               for x in leaves(eng.params)),
                           [tuple(x.shape) for x in leaves(eng.params["language_model"])])
    if rank == 0:
        out["logits"][name] = first_logits(eng, cfg, inp["prompts"] + ["<image>\nwhat?"],
                                           [None] * len(inp["prompts"]) + [inp["image"]])
        out["streams"][name] = [eng.generate(request(r)) for r in case["requests"]]
        eng.stop()
        if case.get("ref"):
            ref = BatchedEngine(from_numpy(tree, "cpu"), cfg, tok, **dict(kw, **case["ref"]))
            try:
                out["ref"][name] = [ref.generate(request(r)) for r in case["requests"]]
            finally:
                ref.stop()
    else:
        out["followed"][name] = eng.follow()
    out["state"][name] = state(eng)


for name, case in inp["cases"]:
    serve(name, case)

# the Generator: streams and beam search
for kind in ("llama", "mpt"):
    cfg = LlavaConfig.from_json(inp["cfg"][kind])
    gen = Generator(from_numpy(inp["trees"][kind], "cpu"), cfg, tok, device="cpu",
                    max_seq_len=96, prefill_bucket=32, cache_dtype=torch.float32, mesh=mesh)
    if rank == 0:
        out["streams"]["gen_" + kind] = [gen.generate(p, max_new_tokens=8).output_ids
                                         for p in inp["prompts"]]
        out["streams"]["beam_" + kind] = gen.beam_search("hello", num_beams=2,
                                                         max_new_tokens=6).output_ids
        gen.stop()
        one = Generator(from_numpy(inp["trees"][kind], "cpu"), cfg, tok, device="cpu",
                        max_seq_len=96, prefill_bucket=32, cache_dtype=torch.float32)
        out["ref"]["beam_" + kind] = one.beam_search("hello", num_beams=2,
                                                     max_new_tokens=6).output_ids
    else:
        out["followed"]["gen_" + kind] = gen.follow()
out["given_amax"] = given[0]
with open(f"{d}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _requests(prompts, n=NEW, **kw):
    return [dict(prompt=p, max_new_tokens=n, **kw) for p in prompts]


def _cases():
    """(name, case): the served configuration, the tree, the requests and,
    for the ones held to the port's one-rank engine, its arguments."""
    dense = dict(max_slots=2, max_seq_len=96, prefill_bucket=32, cache_dtype="float32")
    paged = dict(max_slots=2, max_seq_len=128, prefill_bucket=32, page_size=32, paged=True,
                 cache_dtype="int8")
    repeat = "the cat sat on the mat and the cat sat on the mat"
    greedy = _requests(PROMPTS) + [dict(prompt="<image>\nwhat?", max_new_tokens=NEW,
                                        image=True)]
    sampled = [dict(prompt="hello there", max_new_tokens=NEW, temperature=0.8, seed=3)]
    return [
        ("llama_dense_f32", dict(kind="llama", tree="llama", kw=dense,
                                 requests=greedy + sampled)),
        ("llama_paged_int8", dict(kind="llama", tree="llama_int8", kw=paged,
                                  requests=greedy + _requests([repeat, repeat + " again"]))),
        ("mpt_dense_f32", dict(kind="mpt", tree="mpt", kw=dense, requests=greedy)),
        ("mpt_paged_int8w", dict(kind="mpt", tree="mpt_int8", kw=dict(paged, cache_dtype="float32"),
                                 requests=greedy)),
        # JAX's MPT prefill attends an int8 cache's quantized chunk, the
        # port the chunk itself (models/mpt.py): held to the one-rank port
        ("mpt_dense_int8kv", dict(kind="mpt", tree="mpt", kw=dict(dense, cache_dtype="int8"),
                                  requests=_requests(PROMPTS), ref={"mesh": None})),
        ("llama_spec", dict(kind="llama", tree="llama_int8", kw=dict(dense, speculate=3),
                            requests=_requests([repeat, "abab abab abab"], n=12),
                            ref={"speculate": 0})),
        ("mpt_spec_paged", dict(kind="mpt", tree="mpt", kw=dict(paged, speculate=3),
                                requests=_requests([repeat], n=12), ref={"speculate": 0})),
        ("llama_w8a8", dict(kind="llama", tree="llama_int8",
                            kw=dict(dense, max_seq_len=512, prefill_bucket=256, w8a8=True),
                            requests=_requests(PROMPTS), ref={"mesh": None})),
    ]


def _jax_trees():
    jl, jm = jax_tiny_config(), jax_tiny_mpt_config()
    llama = jax_llava.init_params(jl, jax.random.PRNGKey(0), dtype=jnp.float32)
    mptp = jax_llava.init_params(jm, jax.random.PRNGKey(1), dtype=jnp.float32)
    return {
        "llama": llama, "mpt": mptp,
        "llama_int8": jax_quant.quantize_llava_params(llama, bits=8, fuse=True),
        "mpt_int8": jax_quant.quantize_llava_params(mptp, "mpt", bits=8),
    }


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Start the ranks, then compute JAX's side while they run."""
    d = tmp_path_factory.mktemp("tp_serving")
    jtrees = _jax_trees()
    jcfg = {"llama": jax_tiny_config(), "mpt": jax_tiny_mpt_config()}
    image = np.random.default_rng(1).normal(size=(1, 28, 28, 3)).astype(np.float32)
    cases = _cases()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"trees": {k: _np(v) for k, v in jtrees.items()},
                     "cfg": {k: c.to_json() for k, c in jcfg.items()},
                     "cases": cases, "prompts": PROMPTS, "image": image}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        with open(d / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), "2",
                                           str(d)], cwd=d, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        want = _jax_side(jtrees, jcfg, cases, image)
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{r}.log").read_text()[-4000:]
    outs = []
    for r in range(2):
        with open(d / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, want


def _jax_side(jtrees, jcfg, cases, image):
    """JAX's (1, 1, 2) mesh engines and Generators on the same trees:
    first-token logits and greedy streams."""
    mesh = jax_make_mesh(1, 1, 2)
    tok = CharTokenizer()
    want = {"logits": {}, "streams": {}}
    for name, case in cases:
        if case.get("ref"):
            continue   # held to the port's one-rank engine
        kw = {k: v for k, v in case["kw"].items() if k != "cache_dtype"}
        kw["cache_dtype"] = getattr(jnp, case["kw"]["cache_dtype"])
        eng = jax_engine.BatchedEngine(jtrees[case["tree"]], jcfg[case["kind"]], tok, mesh=mesh,
                                       **kw)
        try:
            batch, _ = jax_prepare(jcfg[case["kind"]], tok, PROMPTS + ["<image>\nwhat?"],
                                   [None] * len(PROMPTS) + [image], max_seq_len=eng.max_seq_len,
                                   prefill_bucket=eng.prefill_bucket)
            cache = eng._make_cache(batch=3, seq_len=int(batch.tokens.shape[1]),
                                    force_dense=True)
            want["logits"][name] = np.asarray(eng._prefill(eng.params, batch, cache)[0])
            streams = []
            for r in case["requests"]:
                if r.get("temperature", 0.0) > 0:
                    streams.append(None)   # the port's sampling is its own
                    continue
                r = dict(r)
                if r.pop("image", False):
                    r["images"] = image
                streams.append(eng.generate(jax_engine.Request(**r)))
            want["streams"][name] = streams
        finally:
            eng.stop()
    for kind in ("llama", "mpt"):
        gen = JaxGenerator(jtrees[kind], jcfg[kind], tok, max_seq_len=96, prefill_bucket=32,
                           cache_dtype=jnp.float32, attn_impl="xla", mesh=mesh)
        want["streams"]["gen_" + kind] = [gen.generate(p, max_new_tokens=8,
                                                       temperature=0.0).output_ids
                                          for p in PROMPTS]
    return want


@pytest.mark.parametrize("name", ["llama_dense_f32", "llama_paged_int8", "mpt_dense_f32",
                                  "mpt_paged_int8w"])
def test_tp2_engine_matches_jax_mesh_engine(served, name):
    """First-token logits (text and image prompts) at the f32 tolerance and
    greedy streams equal to JAX's engine on a (1, 1, 2) mesh."""
    (out, _), want = served
    np.testing.assert_allclose(out["logits"][name], want["logits"][name], **TOL)
    for got, ref in zip(out["streams"][name], want["streams"][name]):
        if ref is not None:
            assert got == ref
    assert all(out["streams"][name])


@pytest.mark.parametrize("kind", ["llama", "mpt"])
def test_tp2_generator_matches_jax_mesh_generator(served, kind):
    """``Generator(mesh=)``: greedy streams equal to JAX's mesh Generator;
    beam search equal to the port's one-rank Generator."""
    (out, _), want = served
    assert out["streams"]["gen_" + kind] == want["streams"]["gen_" + kind]
    assert out["streams"]["beam_" + kind] == out["ref"]["beam_" + kind]


@pytest.mark.parametrize("name", ["llama_spec", "mpt_spec_paged", "llama_w8a8",
                                  "mpt_dense_int8kv"])
def test_tp2_speculation_and_w8a8_match_one_rank(served, name):
    """Speculation (dense LLaMA, paged MPT), W8A8 and MPT over an int8 KV
    cache at tp = 2 give the port's one-rank greedy streams; the W8A8
    prefills quantized their row-parallel products' rows by the given
    (all-reduced) amax on both ranks."""
    (out, fol), _ = served
    assert out["streams"][name] == out["ref"][name]
    assert all(out["streams"][name])
    if name == "llama_w8a8":
        assert out["given_amax"] > 0 and fol["given_amax"] == out["given_amax"]


def test_followers_replicate_rank0(served):
    """Every op a follower replayed returned what rank 0's did (first tokens,
    decode chunks, speculative rows, sampled tokens included), and both ranks
    end with the same replicated state (tokens, seg rows, page tables,
    allocations, speculation history). The followers left their loop when
    rank 0 stopped, having replayed every op."""
    (out, fol), _ = served
    for name in out["ops"]:
        a, b = out["ops"][name], fol["ops"][name]
        assert [op for op, _ in a] == [op for op, _ in b], name
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b)), name
        assert fol["followed"][name] >= len(b) > 0
        for key, value in out["state"][name].items():
            np.testing.assert_array_equal(value, fol["state"][name][key], err_msg=name + key)
    assert fol["followed"]["gen_llama"] > 0 and fol["followed"]["gen_mpt"] > 0


def test_serving_tree_is_plain_local_tensors(served):
    """No DTensor on the serving path: every leaf is a plain tensor, and the
    split ones are each rank's half (the tiny LLaMA's wq: 32 of 64 columns a
    rank, wo 32 of 64 rows, its head 256 of the 512 vocab)."""
    (out, fol), _ = served
    for o in (out, fol):
        for name, (plain, shapes) in o["leaves"].items():
            assert plain, name
    _, shapes = out["leaves"]["llama_dense_f32"]
    assert {(2, 64, 32), (2, 32, 64), (64, 256)} <= set(shapes)
