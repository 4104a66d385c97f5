"""LoRA: low-rank adaptation as a parameter-tree transform.

Counterpart of ``llava_plus_tpu/train/lora.py``. The base tree stays frozen
(plain, or quantized to int8 / int4 for QLoRA), a parallel low-rank tree
``{"layers/attn/wq": {"a": [L, in, r], "b": [L, r, out]}, ...}`` trains,
and the effective weight is ``W + (alpha / r) * a @ b``:

- lazily (:func:`apply_lora`): ``lora_a`` / ``lora_b`` (pre-scaled by
  alpha / r) sit beside each target weight, and ``ops.quant.matmul``
  computes ``x @ W + (x @ a) @ b``; a quantized base stays quantized on the
  card and runs the int8 / int4 kernels, whose gradient reaches x;
- or merged (``materialize=True``, :func:`merge_lora_into_base`), the
  reference's ``merge_and_unload``.

Over a (dp, fsdp, tp) mesh the adapters stay replicated, and the mesh
products of ``ops/quant.py`` add the adapter term in the base product's
placement on local shards: ``(x @ a) @ b_r`` with b's ``tp`` columns for a
column-parallel base, ``(x_r @ a_r) @ b`` with a's rows matching x's ``tp``
slice, summed into the base's partial sum, for a row-parallel one.

Either layer layout works: the stacked ``[L, ...]`` tree, or the trainer's
per-layer list (``models/convert.py:per_layer``) with the adapters as a list
of per-layer dicts (:func:`lora_per_layer`), so each layer's adapters are
their own autograd leaves.

Checkpoint interop with PEFT: :func:`save_peft_adapter` writes
``adapter_config.json`` + ``adapter_model.safetensors`` (+ the
``non_lora_trainables.bin`` split of the reference trainer), and
:func:`load_peft_adapter` reads such a directory back, and
:func:`merge_lora_checkpoint` merges one into its base model (the LoRA load
path of ``models/builder.load_pretrained_model``).

``init_lora_params`` takes a ``torch.Generator``: JAX's ``PRNGKey(1)`` draws
cannot be reproduced, so tests hand both packages the same numpy adapters.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch

from llava_plus_torch.ops import quant


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    dropout: float = 0.05  # the reference default; recorded, not applied

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


# Stacked LLaMA layer matrices targeted by LoRA: every linear layer but the
# multimodal modules (the reference's find_all_linear_names).
LLAMA_TARGETS = (
    ("layers", "attn", "wq"),
    ("layers", "attn", "wk"),
    ("layers", "attn", "wv"),
    ("layers", "attn", "wo"),
    ("layers", "mlp", "w_gate"),
    ("layers", "mlp", "w_up"),
    ("layers", "mlp", "w_down"),
)

_PEFT_NAME_MAP = {
    "q_proj": ("layers", "attn", "wq"),
    "k_proj": ("layers", "attn", "wk"),
    "v_proj": ("layers", "attn", "wv"),
    "o_proj": ("layers", "attn", "wo"),
    "gate_proj": ("layers", "mlp", "w_gate"),
    "up_proj": ("layers", "mlp", "w_up"),
    "down_proj": ("layers", "mlp", "w_down"),
}

Lora = Union[Dict[str, dict], List[Dict[str, dict]]]


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _in_out(w):
    """(L, in, out) of a stacked target, plain or quantized."""
    if quant.is_quantized(w):
        if quant.Q4KEY in w:  # [L, in/2, out] packed nibbles
            L, half_in, d_out = w[quant.Q4KEY].shape
            return L, 2 * half_in, d_out
        return tuple(w[quant.QKEY].shape)
    return tuple(w.shape)


def _device(w):
    """The device of a target, plain or quantized."""
    return (w[quant.Q4KEY if quant.Q4KEY in w else quant.QKEY] if quant.is_quantized(w)
            else w).device


def init_lora_params(lm_params, cfg: LoraConfig, generator: torch.Generator,
                     dtype=torch.float32, targets=LLAMA_TARGETS):
    """``{"layers/attn/wq": {"a": [L, in, r], "b": [L, r, out]}, ...}`` for
    the stacked tree ``lm_params``: a ~ N(0, 0.02), b = 0 (training starts
    at the base model), each made on its target's device (a base on the
    meta device sizes its adapters without their memory)."""
    lora = {}
    for path in targets:
        w = _get(lm_params, path)
        L, d_in, d_out = _in_out(w)
        a = torch.randn(L, d_in, cfg.r, generator=generator, device=_device(w))
        lora["/".join(path)] = {
            "a": (a * 0.02).to(dtype),
            "b": torch.zeros(L, cfg.r, d_out, dtype=dtype, device=_device(w)),
        }
    return lora


def lora_per_layer(lora: Dict[str, dict]) -> List[Dict[str, dict]]:
    """The adapters as a list of per-layer dicts of views of the stacked
    tensors (an in-place update of either is seen by both)."""
    L = next(iter(lora.values()))["a"].shape[0]
    return [{k: {"a": ab["a"][i], "b": ab["b"][i]} for k, ab in lora.items()}
            for i in range(L)]


def lora_stacked(lora: Lora) -> Dict[str, dict]:
    """The stacked layout of either layout (a copy of a per-layer list)."""
    if not isinstance(lora, list):
        return lora
    return {k: {n: torch.stack([lay[k][n] for lay in lora]) for n in ("a", "b")}
            for k in lora[0]}


def _copy_dicts(t):
    """The tree's dicts and lists copied, its tensors (and quantized
    leaves) shared."""
    if isinstance(t, dict) and not quant.is_quantized(t):
        return {k: _copy_dicts(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_copy_dicts(v) for v in t]
    return t


def _adapted(w, a, b, cfg: LoraConfig, materialize: bool):
    if not materialize:
        base = dict(w) if quant.is_quantized(w) else {quant.WKEY: w}
        base[quant.LORA_A] = a
        base[quant.LORA_B] = b * cfg.scaling
        return base
    if quant.is_quantized(w):
        w = quant.dequantize_array(w, torch.bfloat16)
    delta = (a.float() @ b.float()) * cfg.scaling
    return (w.float() + delta).to(w.dtype)


def apply_lora(lm_params, lora_params: Lora, cfg: LoraConfig, materialize: bool = False):
    """The base tree with the adapters applied (a new tree; the base's
    tensors are shared, not copied).

    Default (lazy): ``lora_a`` / ``lora_b`` (pre-scaled by alpha / r) next to
    each target weight, for ``ops.quant.matmul``; the base is never
    materialized. ``materialize=True`` builds merged weights ``W + scaling *
    a @ b`` in the base's dtype (a quantized base dequantized to bf16), the
    checkpoint-merge path. ``lm_params`` stacked with stacked adapters, or
    per layer (``layers`` a list) with either."""
    out = _copy_dicts(lm_params)
    if isinstance(out["layers"], list):
        layers = lora_params if isinstance(lora_params, list) else lora_per_layer(lora_params)
        for lay, adapters in zip(out["layers"], layers):
            for joined, ab in adapters.items():
                path = tuple(joined.split("/"))[1:]   # below "layers"
                _set(lay, path, _adapted(_get(lay, path), ab["a"], ab["b"], cfg, materialize))
        return out
    for joined, ab in lora_stacked(lora_params).items():
        path = tuple(joined.split("/"))
        _set(out, path, _adapted(_get(out, path), ab["a"], ab["b"], cfg, materialize))
    return out


def merge_lora_into_base(params, lora_params: Lora, cfg: LoraConfig):
    """Merge the adapters into the language model for good (the reference's
    ``merge_and_unload``)."""
    return dict(params, language_model=apply_lora(params["language_model"], lora_params, cfg,
                                                  materialize=True))


# ---------------------------------------------------------------------------
# PEFT checkpoint interop
# ---------------------------------------------------------------------------

def load_peft_adapter(adapter_dir, num_layers: int):
    """A PEFT LoRA directory -> (stacked adapters as f32 CPU tensors,
    LoraConfig). PEFT stores per layer ``...layers.N.self_attn.q_proj.
    lora_A.weight`` [r, in] and ``lora_B.weight`` [out, r]; they come back
    transposed and stacked: a [L, in, r], b [L, r, out]."""
    adapter_dir = Path(adapter_dir)
    peft_cfg = json.loads((adapter_dir / "adapter_config.json").read_text())
    cfg = LoraConfig(r=peft_cfg["r"], alpha=peft_cfg["lora_alpha"])
    st = adapter_dir / "adapter_model.safetensors"
    if st.exists():
        from safetensors.torch import load_file

        sd = load_file(str(st))
    else:
        sd = torch.load(str(adapter_dir / "adapter_model.bin"), map_location="cpu",
                        weights_only=True)

    def find(i, proj, part):
        return next((k for k in sd if f"layers.{i}." in k and f"{proj}.{part}" in k), None)

    lora: Dict[str, dict] = {}
    for proj, path in _PEFT_NAME_MAP.items():
        a_list, b_list = [], []
        for i in range(num_layers):
            a_key, b_key = find(i, proj, "lora_A"), find(i, proj, "lora_B")
            if a_key is None or b_key is None:
                break
            a_list.append(sd[a_key].float().T)   # [in, r]
            b_list.append(sd[b_key].float().T)   # [r, out]
        if len(a_list) == num_layers:
            lora["/".join(path)] = {"a": torch.stack(a_list), "b": torch.stack(b_list)}
    return lora, cfg


def merge_lora_checkpoint(adapter_dir, base_dir, dtype="bfloat16"):
    """The builder's LoRA load path: the base LLaMA, the adapters merged into
    it (:func:`merge_lora_into_base`), the projector from
    ``non_lora_trainables.bin`` and the vision tower; returns ``(tokenizer,
    params, LlavaConfig)`` with CPU tensors in ``dtype``. The adapters are
    found by their tensors' names, whatever ``target_modules`` lists (the
    JAX package's leaf names or the HF module names). ``config.json`` is the
    trainers' nested ``LlavaConfig`` or a flat HF config."""
    from llava_plus_torch.models import hf_import
    from llava_plus_torch.models.builder import _load_vision_tower, load_tokenizer
    from llava_plus_torch.models.configs import LlavaConfig

    adapter_dir, base_dir = Path(adapter_dir), Path(base_dir)
    cfg_d = json.loads((adapter_dir / "config.json").read_text())
    if isinstance(cfg_d.get("text"), dict):
        cfg = LlavaConfig.load(adapter_dir / "config.json")
    else:
        cfg = LlavaConfig(
            text=hf_import.llama_config_from_hf(cfg_d),
            mm_projector_type=cfg_d.get("mm_projector_type", "linear"),
            mm_hidden_size=cfg_d.get("mm_hidden_size", 1024),
            image_aspect_ratio=cfg_d.get("image_aspect_ratio", "square"),
        )
    lm = hf_import.llama_params_from_state_dict(hf_import.load_state_dict_dir(base_dir),
                                                cfg.text, dtype=dtype)
    adapters, lora_cfg = load_peft_adapter(adapter_dir, cfg.text.num_hidden_layers)
    params = merge_lora_into_base({"language_model": lm}, adapters, lora_cfg)

    # the non-LoRA trainables: the projector
    proj = {}
    nlt = adapter_dir / "non_lora_trainables.bin"
    if nlt.exists():
        extra = torch.load(str(nlt), map_location="cpu", weights_only=True)
        extra = {k.replace("base_model.model.", "").replace("model.mm_projector.", ""):
                 v.float() for k, v in extra.items() if "mm_projector" in k}
        proj = hf_import.projector_params_from_state_dict(extra, cfg.mm_projector_type,
                                                          dtype=dtype)
    params.update(vision_tower=_load_vision_tower(cfg_d, cfg, dtype), mm_projector=proj)
    return load_tokenizer(str(adapter_dir)), params, cfg


def save_peft_adapter(lora_params: Lora, cfg: LoraConfig, out_dir,
                      extra_trainables: Optional[dict] = None):
    """Write ``adapter_config.json`` + ``adapter_model.safetensors`` (f32),
    and ``non_lora_trainables.bin`` for ``extra_trainables`` (the
    reference trainer's split), as the JAX package writes them except for
    ``target_modules``, which name the HF modules so that ``peft`` loads
    the directory."""
    from safetensors.torch import save_file

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA", "r": cfg.r, "lora_alpha": cfg.alpha,
        "lora_dropout": cfg.dropout,
        # the HF module names peft resolves (the JAX package writes its own
        # leaf names, wq ..., which peft finds in no LLaMA: ROADMAP, Faults)
        "target_modules": sorted(_PEFT_NAME_MAP),
    }, indent=2))
    inv = {"/".join(v): k for k, v in _PEFT_NAME_MAP.items()}
    flat = {}
    for joined, ab in lora_stacked(lora_params).items():
        proj = inv[joined]
        # transposed where the adapters live (a card lays them out far
        # faster than the host), then each layer's own host copy
        a, b = (ab[n].detach().float().transpose(1, 2).contiguous() for n in ("a", "b"))
        block = "self_attn" if "attn" in joined else "mlp"
        for i in range(a.shape[0]):
            prefix = f"base_model.model.model.layers.{i}.{block}.{proj}"
            flat[f"{prefix}.lora_A.weight"] = a[i].to("cpu", copy=True)
            flat[f"{prefix}.lora_B.weight"] = b[i].to("cpu", copy=True)
    save_file(flat, str(out_dir / "adapter_model.safetensors"))
    if extra_trainables:
        torch.save({k: v.detach().cpu() for k, v in extra_trainables.items()},
                   str(out_dir / "non_lora_trainables.bin"))
