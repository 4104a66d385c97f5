"""Checkpointing: resumable training state and the HF-format exports.

Counterpart of ``llava_plus_tpu/train/checkpoint.py`` for the saves the
port's trainer makes:

- adapter-only ``mm_projector.bin`` (stage 1, ``tune_mm_mlp_adapter``);
- the full state dict as an HF-layout ``model.safetensors`` + ``config.json``
  (the same keys, shapes and bytes as the JAX package's export);
- the training state (parameters, optimizer state, step) under
  ``<output_dir>/checkpoint-<step>/``, the JAX package's directory naming:
  one ``torch.save`` file from a one-process run, or, from a run over a
  mesh, a ``torch.distributed.checkpoint`` directory to which each rank
  writes only its own shards of the DTensors (replicated shards once), as
  orbax writes the JAX package's state shard by shard;
- delta weights (``make_delta`` / ``apply_delta``).

The exporters take either layer layout of the language model (stacked
``[L, ...]`` leaves or the trainer's per-layer list) and give per-layer HF
tensors on the CPU in the parameters' dtype.

Over a mesh the trainer's exports (the HF checkpoint, the adapters) pass
their trees through :func:`gathered` on every rank (a collective, leaf by
leaf): rank 0 gets the whole tree on its host and writes it, every other
rank holds at most one whole leaf at a time and gets None leaves.
:func:`restore_train_state` reads either format into the given trees in
place, whatever their placement: DTensors on the saving mesh or another
one, or plain tensors in one process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.convert import tree_map

CKPT_PREFIX = "checkpoint-"
STATE_FILE = "state.pt"      # a one-process run's state
SHARDED_DIR = "state"        # a run over a mesh: the ranks' shards


# ---------------------------------------------------------------------------
# Training state
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples; None leaves
    are left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def _sharded(tree) -> bool:
    return any(isinstance(x, DTensor) for _, x in _flat(tree))


def save_train_state(ckpt_dir, step: int, params, opt_state=None,
                     cfg: Optional[LlavaConfig] = None, position=None) -> Path:
    """Write the training state of ``step`` under ``checkpoint-<step>/``,
    then ``meta.json``, the marker of a finished save, which holds ``step``
    and the data ``position`` (``{"epoch", "index"}``: the epoch, and the
    index in that epoch's order of the first sample no trained step has
    used), when given.

    Trees of DTensors (a run over a mesh): every rank of the mesh calls
    this; each writes only its own shards, the leaves as placed (one copy
    of a replicated shard), into ``state/``, and rank 0 writes
    ``meta.json`` once every rank has finished. Plain trees (one process):
    ``state.pt``, the trees as they are held (per-layer views of a stacked
    tensor are saved once, with their storage)."""
    path = Path(ckpt_dir) / f"{CKPT_PREFIX}{step}"
    path.mkdir(parents=True, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    rank = 0
    if _sharded(state):
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        dcp.save(dict(_flat(state)), storage_writer=dcp.FileSystemWriter(path / SHARDED_DIR))
        dist.barrier()   # every rank's shards are on disk before the marker
        rank = dist.get_rank()
    else:
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path / STATE_FILE)
    if rank == 0:
        (path / "meta.json").write_text(json.dumps({"step": step, **(position or {})}))
        if cfg is not None:
            cfg.save(path / "config.json")
    return path


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """The finished checkpoint of the highest step, or None. A save cut
    before ``meta.json`` was written is skipped."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)", p.name)
        if (m and int(m.group(1)) > best_step and (p / "meta.json").exists()
                and ((p / STATE_FILE).exists() or (p / SHARDED_DIR).is_dir())):
            best, best_step = p, int(m.group(1))
    return best


def data_position(path, samples_per_step: int):
    """``(epoch, index)`` where a run resumed from the checkpoint ``path``
    takes up the data: the position its save recorded, or, for a save that
    recorded none (before positions were recorded), ``step *
    samples_per_step`` of the first epoch."""
    meta = json.loads((Path(path) / "meta.json").read_text())
    if "epoch" in meta:
        return int(meta["epoch"]), int(meta["index"])
    return 0, int(meta["step"]) * samples_per_step


def gathered(tree, rank: int = 0):
    """The tree with every DTensor gathered whole to the host of rank 0,
    leaf by leaf (a collective: every rank of the mesh calls it, with its
    own rank; one that passes none is taken for rank 0). Rank 0 gets the
    whole tree on the CPU, other leaves as they are; every other rank gets
    None leaves and holds at most one whole leaf at a time (on its
    device)."""
    def leaf(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
            return x.cpu() if rank == 0 else None
        return x if rank == 0 else None

    return tree_map(leaf, tree)


def _copy_into(like, saved):
    """Copy ``saved``'s leaves into ``like``'s tensors in place (so views of
    a stacked tensor stay views); plain values come back from ``saved``."""
    if isinstance(like, dict):
        return {k: _copy_into(v, saved[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_copy_into(a, b) for a, b in zip(like, saved))
    if isinstance(like, torch.Tensor):
        if like.shape != saved.shape:
            raise ValueError(f"checkpoint leaf {tuple(saved.shape)} does not fit "
                             f"{tuple(like.shape)}")
        if isinstance(like, DTensor):
            saved = distribute_tensor(saved.to(like.to_local().device), like.device_mesh,
                                      like.placements)
        return like.copy_(saved)
    return saved


def _unflat(like, flat, prefix=""):
    """``like`` with each leaf replaced by ``flat``'s value at its path."""
    if isinstance(like, dict):
        return {k: _unflat(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflat(v, flat, f"{prefix}/{i}") for i, v in enumerate(like))
    return like if like is None else flat[prefix]


def restore_train_state(path, params_like, opt_state_like=None, timings=None):
    """``({"params", "opt_state"}, step)``: the saved state copied into the
    given trees in place, one leaf at a time. ``state.pt`` is read from a
    memory-mapped file; a sharded save is read by every rank that holds the
    trees (a collective when a process group is up), each reading the parts
    of the saved shards that its own shards cover, so the trees may be
    placed on the saving mesh, on another mesh shape, or be plain tensors
    in one process. ``timings``, a dict, gets the seconds of the load
    (``load_s``: mapping ``state.pt``, or the whole sharded read) and of the
    copy into the trees (``copy_s``, which reads the mapped pages)."""
    path = Path(path)
    like = {"params": params_like}
    if opt_state_like is not None:
        like["opt_state"] = opt_state_like
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    if (path / STATE_FILE).exists():
        saved = torch.load(path / STATE_FILE, map_location="cpu", mmap=True,
                           weights_only=True)
        t1 = time.perf_counter()
        state = {k: _copy_into(v, saved[k]) for k, v in like.items()}
        timings.update(load_s=t1 - t0, copy_s=time.perf_counter() - t1)
    else:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        flat = dict(_flat(like))
        alone = not (dist.is_available() and dist.is_initialized())
        with warnings.catch_warnings():
            # one process reading a sharded save is what ``alone`` asks for
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            dcp.load(flat, storage_reader=dcp.FileSystemReader(path / SHARDED_DIR),
                     no_dist=alone)
        state = _unflat(like, flat)
        timings.update(load_s=time.perf_counter() - t0, copy_s=0.0)
    step = json.loads((path / "meta.json").read_text())["step"]
    return state, step


# ---------------------------------------------------------------------------
# HF-format export (the inverse of the JAX package's models/hf_import.py)
# ---------------------------------------------------------------------------

def _t(x: torch.Tensor) -> torch.Tensor:
    # laid out on its own device first: a card transposes far faster than
    # the host
    return x.detach().contiguous().cpu()


def _per_layer(node, path, L):
    """Layer i's leaf at ``path`` for i < L, from either layer layout."""
    if isinstance(node, list):
        out = []
        for lay in node:
            for p in path:
                lay = lay[p]
            out.append(lay)
        return out
    for p in path:
        node = node[p]
    return [node[i] for i in range(L)]


def llama_state_dict_from_params(lm, cfg) -> Dict[str, torch.Tensor]:
    sd = {
        "model.embed_tokens.weight": _t(lm["embed_tokens"]),
        "model.norm.weight": _t(lm["final_norm"]),
    }
    if "lm_head" in lm:
        sd["lm_head.weight"] = _t(lm["lm_head"].T)
    layer_map = [
        ("self_attn.q_proj.weight", ("attn", "wq"), True),
        ("self_attn.k_proj.weight", ("attn", "wk"), True),
        ("self_attn.v_proj.weight", ("attn", "wv"), True),
        ("self_attn.o_proj.weight", ("attn", "wo"), True),
        ("mlp.gate_proj.weight", ("mlp", "w_gate"), True),
        ("mlp.up_proj.weight", ("mlp", "w_up"), True),
        ("mlp.down_proj.weight", ("mlp", "w_down"), True),
        ("input_layernorm.weight", ("input_norm",), False),
        ("post_attention_layernorm.weight", ("post_attn_norm",), False),
    ]
    for hf_name, path, transpose in layer_map:
        for i, m in enumerate(_per_layer(lm["layers"], path, cfg.num_hidden_layers)):
            sd[f"model.layers.{i}.{hf_name}"] = _t(m.T if transpose else m)
    return sd


def mpt_state_dict_from_params(lm, cfg) -> Dict[str, torch.Tensor]:
    """LLaVA-MPT's decoder keys (``transformer.wte`` / ``blocks.N`` /
    ``norm_f``, the reference ``llava_mpt.py``), as the JAX package writes
    them."""
    sd = {
        "transformer.wte.weight": _t(lm["wte"]),
        "transformer.norm_f.weight": _t(lm["norm_f"]),
    }
    if "wpe" in lm:
        sd["transformer.wpe.weight"] = _t(lm["wpe"])
    layer_map = [
        ("norm_1.weight", ("norm1",), False),
        ("norm_2.weight", ("norm2",), False),
        ("attn.Wqkv.weight", ("attn", "wqkv"), True),
        ("attn.out_proj.weight", ("attn", "out_proj"), True),
        ("ffn.up_proj.weight", ("mlp", "up_proj"), True),
        ("ffn.down_proj.weight", ("mlp", "down_proj"), True),
    ]
    for hf_name, path, transpose in layer_map:
        for i, m in enumerate(_per_layer(lm["layers"], path, cfg.n_layers)):
            sd[f"transformer.blocks.{i}.{hf_name}"] = _t(m.T if transpose else m)
    return sd


def clip_state_dict_from_params(vt, cfg,
                                prefix="model.vision_tower.vision_tower.vision_model."
                                ) -> Dict[str, torch.Tensor]:
    D, P = cfg.hidden_size, cfg.patch_size
    sd = {
        prefix + "embeddings.class_embedding": _t(vt["class_embedding"]),
        prefix + "embeddings.patch_embedding.weight":
            _t(vt["patch_embedding"].T.reshape(D, 3, P, P)),
        prefix + "embeddings.position_embedding.weight": _t(vt["position_embedding"]),
        prefix + "pre_layrnorm.weight": _t(vt["pre_layernorm"]["scale"]),
        prefix + "pre_layrnorm.bias": _t(vt["pre_layernorm"]["bias"]),
        prefix + "post_layernorm.weight": _t(vt["post_layernorm"]["scale"]),
        prefix + "post_layernorm.bias": _t(vt["post_layernorm"]["bias"]),
    }
    lay = vt["layers"]
    pairs = [
        ("layer_norm1.weight", lay["ln1"]["scale"], False),
        ("layer_norm1.bias", lay["ln1"]["bias"], False),
        ("layer_norm2.weight", lay["ln2"]["scale"], False),
        ("layer_norm2.bias", lay["ln2"]["bias"], False),
        ("self_attn.q_proj.weight", lay["attn"]["wq"], True),
        ("self_attn.q_proj.bias", lay["attn"]["bq"], False),
        ("self_attn.k_proj.weight", lay["attn"]["wk"], True),
        ("self_attn.k_proj.bias", lay["attn"]["bk"], False),
        ("self_attn.v_proj.weight", lay["attn"]["wv"], True),
        ("self_attn.v_proj.bias", lay["attn"]["bv"], False),
        ("self_attn.out_proj.weight", lay["attn"]["wo"], True),
        ("self_attn.out_proj.bias", lay["attn"]["bo"], False),
        ("mlp.fc1.weight", lay["mlp"]["w1"], True),
        ("mlp.fc1.bias", lay["mlp"]["b1"], False),
        ("mlp.fc2.weight", lay["mlp"]["w2"], True),
        ("mlp.fc2.bias", lay["mlp"]["b2"], False),
    ]
    for name, arr, transpose in pairs:
        for i in range(cfg.num_hidden_layers):
            sd[prefix + f"encoder.layers.{i}.{name}"] = _t(arr[i].T if transpose else arr[i])
    return sd


def projector_state_dict_from_params(proj, prefix="model.mm_projector.") -> Dict[str, torch.Tensor]:
    """``<prefix><2i>.weight`` [out, in] and ``.bias`` for linear layer i
    (the GELUs sit at the odd indices of the HF ``nn.Sequential``)."""
    sd = {}
    for i, layer in enumerate(proj.get("layers", [])):
        sd[f"{prefix}{2 * i}.weight"] = _t(layer["w"].T)
        sd[f"{prefix}{2 * i}.bias"] = _t(layer["b"])
    return sd


def _mpt_hf_config(m) -> dict:
    return {
        "architectures": ["LlavaMPTForCausalLM"],
        "model_type": "llava_mpt",
        "vocab_size": m.vocab_size,
        "d_model": m.d_model,
        "n_layers": m.n_layers,
        "n_heads": m.n_heads,
        "expansion_ratio": m.expansion_ratio,
        "max_seq_len": m.max_seq_len,
        "attn_config": {
            "alibi": m.alibi,
            "alibi_bias_max": m.alibi_bias_max,
            "attn_type": "multiquery_attention" if m.multiquery else "multihead_attention",
            "prefix_lm": m.prefix_lm,
            "attn_uses_sequence_id": m.attn_uses_sequence_id,
            "clip_qkv": m.clip_qkv,
            "qk_ln": m.qk_ln,
            "softmax_scale": m.softmax_scale,
        },
        "no_bias": m.no_bias,
        "learned_pos_emb": m.learned_pos_emb,
        "layer_norm_epsilon": m.layer_norm_eps,
        "logit_scale": m.logit_scale,
    }


def _llama_hf_config(t) -> dict:
    return {
        "architectures": ["LlavaLlamaForCausalLM"],
        "model_type": "llava",
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "max_position_embeddings": t.max_position_embeddings,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        **({"rope_scaling": {"type": t.rope_scaling_type, "factor": t.rope_scaling_factor}}
           if t.rope_scaling_type else {}),
        "tie_word_embeddings": t.tie_word_embeddings,
    }


def export_hf_llava(params, cfg: LlavaConfig, out_dir, tokenizer=None) -> Path:
    """Write a full HF-layout LLaVA checkpoint (safetensors + config.json);
    for the MPT backbone the reference LLaVA-MPT layout, with the tower and
    the projector under ``transformer.*`` as well."""
    from safetensors.torch import save_file

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if cfg.language_model_type == "mpt":
        sd = mpt_state_dict_from_params(params["language_model"], cfg.mpt)
        prefix, hf_cfg = "transformer.", _mpt_hf_config(cfg.mpt)
    else:
        sd = llama_state_dict_from_params(params["language_model"], cfg.text)
        prefix, hf_cfg = "model.", _llama_hf_config(cfg.text)
    if params.get("vision_tower"):
        sd.update(clip_state_dict_from_params(
            params["vision_tower"], cfg.vision,
            prefix=prefix + "vision_tower.vision_tower.vision_model."))
    if params.get("mm_projector"):
        sd.update(projector_state_dict_from_params(params["mm_projector"],
                                                   prefix=prefix + "mm_projector."))
    save_file(sd, str(out_dir / "model.safetensors"))

    hf_cfg.update({
        "mm_vision_tower": "openai/clip-vit-large-patch14-336"
            if cfg.vision.image_size == 336 else "openai/clip-vit-large-patch14",
        "mm_projector_type": cfg.mm_projector_type,
        "mm_hidden_size": cfg.mm_hidden_size,
        "mm_vision_select_layer": cfg.vision.select_layer,
        "mm_vision_select_feature": cfg.vision.select_feature,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_use_im_start_end": cfg.mm_use_im_start_end,
        "mm_use_im_patch_token": cfg.mm_use_im_patch_token,
        "tokenizer_model_max_length": cfg.max_sequence_length,
        "torch_dtype": "bfloat16",
        # the vision tower's own dims, so an import never guesses them
        "mm_vision_config": dataclasses.asdict(cfg.vision),
    })
    (out_dir / "config.json").write_text(json.dumps(hf_cfg, indent=2))
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(str(out_dir))
    return out_dir


def export_mm_projector_bin(params, out_path) -> Path:
    """Stage-1 adapter-only save: ``mm_projector.bin`` with
    ``model.mm_projector.`` keys, as f32 tensors."""
    sd = projector_state_dict_from_params(params["mm_projector"])
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.float() for k, v in sd.items()}, str(out_path))
    return out_path



# ---------------------------------------------------------------------------
# Delta weights (the distribution format for license-encumbered bases)
# ---------------------------------------------------------------------------

def make_delta(target_params, base_lm_params):
    """``target - base`` on the language-model subtree, in f32 (both in the
    same layer layout)."""
    return tree_map(lambda t, b: t.detach().float() - b.detach().float(),
                target_params["language_model"], base_lm_params)


def apply_delta(delta_lm, base_lm_params):
    """``delta + base`` on the language-model subtree, in f32."""
    return tree_map(lambda d, b: d.float() + b.detach().float(), delta_lm, base_lm_params)
