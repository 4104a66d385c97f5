"""The trainer: the two-stage visual instruction tuning recipes.

Counterpart of ``llava_plus_tpu/train/train.py`` on one card: build params
-> loop {sample, collate or pack, step} -> checkpoints (+ HF-format
exports). The CLI keeps the JAX package's argument surface (ModelArguments /
DataArguments / TrainingArguments, ``--snake-case`` or ``--snake_case``), so
the recipes of ``scripts/v1_5/`` run unchanged, plus ``--device`` (``cuda``
unless the caller asks for ``cpu``):

    python -m llava_plus_torch.train.train --tiny-debug-model true \
        --data-path data.json --image-folder images --max-steps 2 \
        --per-device-train-batch-size 2 --bf16 false --device cpu \
        --output-dir out

Stage 1 (``--tune-mm-mlp-adapter true``) trains the projector and saves
``mm_projector.bin``; stage 2 trains the language model and the projector
and saves the training state and a final HF export (``--save-only-model``:
the checkpoints hold the parameters alone and the end writes the export
alone). A text-only ``--model-name-or-path`` gets the tower and the
projector that ``--vision-tower`` and ``--mm-projector-type`` name
(:func:`initialize_vision_modules`). The trainer holds the
language model per layer (``models/convert.py:per_layer``, views of the
stacked tensors), so the stacked tree that :func:`train` returns is the
trained one. Either backbone trains: ``--tiny-debug-arch mpt`` builds the
tiny LLaVA-MPT (with ``--version mpt``).

LoRA / QLoRA (``--lora-enable``, ``--bits 4|8``) follows the JAX trainer,
surprises included: ``--bits`` quantizes the language model (unfused, the
LLaMA matrices and the head) before the adapters are made, and only with
``--lora-enable``; only the adapters train, with ``optax.adamw(lr)``'s
defaults (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4 on every adapter,
no clipping, a constant lr; the projector stays frozen and
``--mm-projector-lr`` is ignored); ``grad_norm`` is the adapters' norm;
``--lora-dropout`` is recorded, not applied; the save writes the PEFT
adapter, ``non_lora_trainables.bin`` (the projector) and ``config.json``,
and no training state. The adapters target LLaMA's matrices: LoRA on the MPT
backbone raises ``ValueError``.

    python -m llava_plus_torch.train.train --tiny-debug-model true \
        --lora-enable true --bits 4 --lora-r 8 --lora-alpha 16 \
        --data-path data.json --image-folder images --max-steps 2 \
        --per-device-train-batch-size 2 --bf16 false --device cpu \
        --output-dir out

``--model-name-or-path`` starts from a checkpoint directory, loaded by
``models/builder.load_pretrained_model`` (any of its four shapes), and
``--pretrain-mm-mlp-adapter`` puts a stage-1 ``mm_projector.bin`` into the
projector.

The (dp, fsdp, tp) mesh (``--dp``, ``--fsdp-axis``, ``--tp``) spans the
ranks of a ``torchrun`` launch (its ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` environment; NCCL on the card, gloo with ``--device cpu``;
without it the world is one process). As in the JAX trainer, ``fsdp`` is
the world size over ``dp * tp`` unless ``--fsdp-axis`` names it; ``dp *
tp`` must divide the world size (the JAX trainer computes ``fsdp = 0`` for
``--tp 2`` on one device instead). A mesh of one device is no mesh: the
single-card path. Every rank reads the same global batches, which
``place_batch`` shards; rank 0 logs. ``--tp N`` divides every decoder
product over N ranks as the JAX trainer's GSPMD does (``ops/quant.py``,
column- and row-parallel on local shards): each rank holds 1/N of every
matrix's columns or rows, its heads' attention and 1/N of the FFN's
activations, and does 1/N of their FLOPs; the residual stream, the norms
and the vision tower stay whole on each rank of a ``tp`` group. Each rank writes its own shards of
the training state (``checkpoint.save_train_state``); the exports are
gathered to rank 0 leaf by leaf, which writes them.

    torchrun --nproc-per-node 4 -m llava_plus_torch.train.train \
        --tiny-debug-model true --fsdp-axis 2 --tp 2 --device cpu ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import Replicate, distribute_tensor

from llava_plus_torch import conversation as conversation_lib
from llava_plus_torch.constants import IGNORE_INDEX
from llava_plus_torch.data.dataset import (
    DataConfig,
    LengthGroupedSampler,
    collate_batch,
    make_supervised_dataset,
)
from llava_plus_torch.data.image_processing import (
    ClipImageProcessor,
    processor_for_vision_tower,
)
from llava_plus_torch.models.configs import tiny_llava_config, tiny_llava_mpt_config
from llava_plus_torch.models.convert import per_layer, tree_map
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.ops.quant import quantize_llava_params
from llava_plus_torch.parallel.mesh import activate_mesh, make_mesh
from llava_plus_torch.train import checkpoint as ckpt_lib
from llava_plus_torch.train import lora as lora_lib
from llava_plus_torch.train import step as step_lib
from llava_plus_torch.train.optimizer import (
    OptimizerConfig, build_optimizer, global_norm, tree_leaves,
)
from llava_plus_torch.utils.logging import build_logger


@dataclasses.dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = None
    version: str = "v1"
    vision_tower: Optional[str] = None
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_projector_type: str = "mlp2x_gelu"
    pretrain_mm_mlp_adapter: Optional[str] = None
    tune_mm_mlp_adapter: bool = False
    freeze_backbone: bool = False
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    tiny_debug_model: bool = False  # tests/CI: random tiny model
    tiny_debug_arch: str = "llama"  # "llama" | "mpt" backbone for it
    # accepted for recipe compatibility; attention is the flash kernels
    mpt_attn_impl: Optional[str] = "triton"


@dataclasses.dataclass
class DataArguments:
    data_path: str = ""
    image_folder: str = ""
    image_aspect_ratio: str = "square"
    lazy_preprocess: bool = True
    is_multimodal: bool = True


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str = "./checkpoints/run"
    num_train_epochs: int = 1
    per_device_train_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    model_max_length: int = 2048
    save_steps: int = 500
    # HF's flag: the checkpoints hold the parameters without the optimizer
    # state (a run cannot resume from them: --resume is off) and the run's
    # end writes only the HF export, once, as the reference's final save
    # does; the JAX trainer always writes the whole state at the end (41 GB
    # at 7B beside the 14 GB export)
    save_only_model: bool = False
    logging_steps: int = 1
    group_by_modality_length: bool = False
    # batches prepared ahead on a producer thread so host work (PIL
    # decode, collate/pack) overlaps the device step; 0 = inline
    prefetch_batches: int = 2
    # pack several samples into each fixed [batch, model_max_length] row
    # (segment-id isolated, positions restart per sample)
    pack_sequences: bool = False
    pack_max_images: int = 2
    gradient_checkpointing: bool = True
    bf16: bool = True
    bits: int = 16
    freeze_mm_mlp_adapter: bool = False
    lora_enable: bool = False
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05
    # accepted for recipe compatibility (the optimizer is AdamW as
    # adamw_torch computes it; QLoRA quantizes to blockwise int4 /
    # per-channel int8, not nf4 double-quant; LoRA bias training is
    # unsupported, "none" is what exports)
    optim: str = "adamw_torch"
    remove_unused_columns: bool = False
    double_quant: bool = True
    quant_type: str = "nf4"
    lora_bias: str = "none"
    lora_weight_path: str = ""
    cache_dir: Optional[str] = None
    dp: int = 1
    fsdp_axis: Optional[int] = None
    tp: int = 1
    seed: int = 42
    max_steps: Optional[int] = None
    resume: bool = True
    device: str = "cuda"


def build_mesh(training_args: TrainingArguments):
    """``(mesh or None, rank, device)``: the (dp, fsdp, tp) mesh over the
    ranks of a torchrun launch (JAX ``train.py:258-260``), the process
    group initialised from its environment (NCCL on the card, gloo on the
    CPU); None for a mesh of one device."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp, tp = training_args.dp, training_args.tp
    if dp < 1 or tp < 1 or world % (dp * tp):
        raise ValueError(f"dp * tp = {dp * tp} does not divide the world size {world} "
                         f"(--dp {dp}, --tp {tp})")
    fsdp = training_args.fsdp_axis or world // (dp * tp)
    if dp * fsdp * tp != world:
        raise ValueError(f"the mesh {dp} x {fsdp} x {tp} (dp x fsdp x tp) does not cover the "
                         f"world size {world}")
    device = torch.device(training_args.device)
    if world == 1:
        return None, 0, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_mesh(dp, fsdp, tp, device_type=device.type), dist.get_rank(), device


def build_model(model_args: ModelArguments, dtype: torch.dtype, device, seed: int = 42):
    """(params, cfg, tokenizer) in the stacked layout on ``device``: the
    checkpoint at ``model_name_or_path`` (through the builder), or the tiny
    debug model of ``tiny_debug_arch`` (LLaMA or MPT) with random weights
    from seed 0; then ``pretrain_mm_mlp_adapter``'s projector, if given.

    A checkpoint without a tower (a plain language model, as every recipe
    starts from) gets the vision modules that ``vision_tower`` and
    ``mm_projector_type`` name (:func:`initialize_vision_modules`, the
    reference's ``initialize_vision_modules``; the JAX package's
    ``build_model`` drops both flags there and trains no tower)."""
    from llava_plus_torch.data.debug_tokenizer import DebugTokenizer
    from llava_plus_torch.models import hf_import
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.builder import load_pretrained_model

    if model_args.tiny_debug_model or model_args.model_name_or_path is None:
        mpt = model_args.tiny_debug_arch == "mpt"
        cfg = tiny_llava_mpt_config() if mpt else tiny_llava_config()
        params = llava_model.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                         device, dtype)
        tok = DebugTokenizer(vocab_size=cfg.mpt.vocab_size if mpt else cfg.text.vocab_size)
        if mpt:
            tok.bos_token_id = None  # MPT tokenizers carry no BOS
    else:
        tok, params, cfg, _, _ = load_pretrained_model(model_args.model_name_or_path,
                                                       dtype=dtype, device=device)
        if model_args.vision_tower is not None and not params["vision_tower"]:
            params, cfg = initialize_vision_modules(params, cfg, model_args, dtype, seed)
        params = tree_map(lambda x: x.to(device), params)
    if model_args.pretrain_mm_mlp_adapter:
        sd = torch.load(model_args.pretrain_mm_mlp_adapter, map_location="cpu",
                        weights_only=True)
        sd = {k.replace("model.mm_projector.", ""): v for k, v in sd.items()}
        params["mm_projector"] = tree_map(
            lambda x: x.to(device),
            hf_import.projector_params_from_state_dict(sd, cfg.mm_projector_type, dtype))
    return params, cfg, tok


def vision_config_for_tower(name_or_path: str):
    """The CLIP config of the tower ``name_or_path`` names: a local HF CLIP
    directory's ``config.json``; otherwise CLIP ViT-L/14 at the size that
    :func:`processor_for_vision_tower` gives the name (336 px for a
    ``...-336`` tower, else 224), so the model and its processor agree."""
    import json

    from llava_plus_torch.models import hf_import
    from llava_plus_torch.models.configs import CLIP_VIT_L_224, CLIP_VIT_L_336

    config = Path(name_or_path) / "config.json"
    if config.is_file():
        return hf_import.clip_config_from_hf(json.loads(config.read_text()))
    size = processor_for_vision_tower(name_or_path).crop_size
    return CLIP_VIT_L_336 if size == CLIP_VIT_L_336.image_size else CLIP_VIT_L_224


def initialize_vision_modules(params, cfg, model_args: ModelArguments, dtype, seed: int):
    """The tower and the projector for a tree that has neither (the
    reference's ``initialize_vision_modules``, ``llava_arch.py:27-82``):
    the tower's config from :func:`vision_config_for_tower`, its
    ``select_layer`` / ``select_feature`` from the flags; its weights from
    the local directory, or random (seed 0) with the builder's warning; a
    fresh ``mm_projector_type`` projector from ``seed`` (on the CPU, so the
    values do not depend on the device), ``mm_hidden_size`` the tower's
    width. Returns (params, cfg) on the CPU."""
    from llava_plus_torch.models import projector
    from llava_plus_torch.models.builder import _load_vision_tower

    vision = dataclasses.replace(vision_config_for_tower(model_args.vision_tower),
                                 select_layer=model_args.mm_vision_select_layer,
                                 select_feature=model_args.mm_vision_select_feature)
    cfg = dataclasses.replace(cfg, vision=vision, mm_projector_type=model_args.mm_projector_type,
                              mm_hidden_size=vision.hidden_size)
    tower = _load_vision_tower({"mm_vision_tower": model_args.vision_tower}, cfg, dtype)
    proj = projector.init_params(cfg.mm_projector_type, cfg.mm_hidden_size, cfg.hidden_size,
                                 torch.Generator().manual_seed(seed), "cpu", dtype)
    return dict(params, vision_tower=tower, mm_projector=proj), cfg


def _lora_step_fn(params, cfg, lora_cfg: lora_lib.LoraConfig, lora_layers, learning_rate,
                  remat: bool, accum: int, mesh=None):
    """The LoRA step of the JAX trainer: gradients of the adapters alone
    (held per layer, views of the stacked adapters) through the frozen base
    with the adapters attached lazily, then ``optax.adamw(lr)`` with its
    defaults: weight decay 1e-4 on every adapter, no clipping, a constant
    lr (the port's AdamW with that configuration). Returns ``step(batch) ->
    metrics``; the adapters are updated in place."""
    tree = {"language_model": {"lora": lora_layers}, "mm_projector": {}, "vision_tower": {}}
    opt = build_optimizer(tree, OptimizerConfig(
        learning_rate=learning_rate, weight_decay=1e-4, warmup_ratio=0.0, schedule="constant",
        max_grad_norm=float("inf"), train_mm_projector=False))
    state = opt.init(tree)

    def loss_of(p, mb):
        lm = lora_lib.apply_lora(params["language_model"], p["lora"], lora_cfg)
        return step_lib.loss_fn(dict(params, language_model=lm), cfg, mb, remat=remat)

    def step(batch):
        with activate_mesh(mesh):
            grads, metrics = step_lib.grads_and_metrics(loss_of, {"lora": lora_layers}, batch,
                                                        accum, keys=("lora",))
            metrics["grad_norm"] = global_norm(tree_leaves(grads["lora"]))
            opt.update({"language_model": grads}, state, tree)
        return metrics

    return step


def stack_micro_batches(arrays, pad_token_id: int, max_len: int):
    """K collated batches stacked [K, B, ...] for gradient accumulation.
    Each is padded to the longest T first, as the planner pads a row: pad
    tokens, segment 0, IGNORE_INDEX labels, position ``max_len``; dropped
    image slots (== the batch's T) move to the new T. (The JAX trainer
    stacks them as they come, which fails when their padded lengths
    differ.)"""
    T = max(a["tokens"].shape[-1] for a in arrays)
    fill = {"tokens": pad_token_id, "labels": IGNORE_INDEX, "segment_ids": 0,
            "positions": max_len}
    out = []
    for a in arrays:
        t = a["tokens"].shape[-1]
        a = dict(a)
        if t < T:
            for k, v in fill.items():
                a[k] = np.pad(a[k], ((0, 0), (0, T - t)), constant_values=v)
            a["image_pos"] = np.where(a["image_pos"] >= t, T, a["image_pos"])
        out.append(a)
    return {k: np.stack([a[k] for a in out]) for k in out[0]}


def _prefetched(items, depth: int):
    """``items`` pulled ahead by a producer thread (``depth`` batches), so
    image decode and collate/pack overlap the step; producer errors are
    raised in the loop."""
    if depth <= 0:
        yield from items
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        """Queue ``item``; False once the loop has stopped taking items (a
        full queue then never drains)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in items:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # surfaced in the loop
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def train(model_args: ModelArguments, data_args: DataArguments,
          training_args: TrainingArguments, tokenizer=None, *,
          build_model: Callable = build_model,
          init_lora: Callable = lora_lib.init_lora_params,
          on_step: Optional[Callable] = None,
          on_data: Optional[Callable] = None):
    """Run the recipe; returns (params in the stacked layout, cfg); with
    LoRA the base as it was, and the trained adapters are what the save
    writes. ``build_model(model_args, dtype, device, seed=) -> (params,
    cfg, tokenizer)`` gives the initial weights (``seed`` is ``--seed``),
    ``init_lora(lm_params, lora_cfg, generator)`` the initial stacked
    adapters (updated in place by the training); ``on_step(step, metrics,
    seconds, batch)``, if given, sees every step's metrics (floats), its
    host time and the batch arrays; ``on_data(step, epoch, sample_ids)``
    the epoch and the dataset indices of the samples the step trained on.
    Over a mesh the parameters returned are DTensors.

    A run resumed from ``checkpoint-<step>`` (``--resume``, the default)
    continues where the save left the data: the saved epoch's order (the
    earlier epochs' orders are drawn from the seeded generator and thrown
    away) from the first sample no trained step has used, so it trains on
    the batches of a run that was never cut. (The JAX trainer starts the
    epoch's order again.)"""
    mesh, rank, device = build_mesh(training_args)
    logger = build_logger("train", "train.log")
    if rank:
        logger.setLevel("WARNING")   # rank 0 logs
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    params, cfg, loaded_tokenizer = build_model(model_args, dtype, device,
                                                seed=training_args.seed)
    tokenizer = tokenizer or loaded_tokenizer
    if tokenizer is None:
        raise ValueError("a tokenizer is required for training")

    conv = conversation_lib.conv_templates.get(model_args.version,
                                               conversation_lib.default_conversation)

    # dataset -------------------------------------------------------------
    data_cfg = DataConfig(
        data_path=data_args.data_path,
        image_folder=data_args.image_folder,
        image_aspect_ratio=(data_args.image_aspect_ratio
                            if data_args.image_aspect_ratio != "square" else None),
        is_multimodal=data_args.is_multimodal,
        mm_use_im_start_end=model_args.mm_use_im_start_end,
        conv_version=conv.version,
    )
    # sized by the model's own tower, which build_model made to the
    # --vision-tower flag where the checkpoint had none
    image_processor = ClipImageProcessor(shortest_edge=cfg.vision.image_size,
                                         crop_size=cfg.vision.image_size)
    dataset = make_supervised_dataset(tokenizer, data_cfg, image_processor, conv)
    logger.info(f"train_dataset size: {len(dataset)}")

    batch_size = training_args.per_device_train_batch_size
    accum = max(int(training_args.gradient_accumulation_steps), 1)
    # optimizer steps an epoch, as HF Trainer counts them (the JAX trainer
    # counts micro-batches: accum times too many steps, and accum epochs);
    # packed rows keep its count of rows, since a row holds several samples
    per_step = batch_size if training_args.pack_sequences else batch_size * accum
    steps_per_epoch = max(len(dataset) // per_step, 1)
    total_steps = training_args.max_steps or steps_per_epoch * training_args.num_train_epochs

    # optimizer -----------------------------------------------------------
    opt_cfg = OptimizerConfig(
        learning_rate=training_args.learning_rate,
        mm_projector_lr=training_args.mm_projector_lr,
        weight_decay=training_args.weight_decay,
        warmup_ratio=training_args.warmup_ratio,
        total_steps=total_steps,
        schedule="cosine" if training_args.lr_scheduler_type == "cosine" else "constant",
        train_language_model=not (model_args.tune_mm_mlp_adapter
                                  or model_args.freeze_backbone),
        train_mm_projector=not training_args.freeze_mm_mlp_adapter,
        train_vision_tower=False,
    )
    remat = training_args.gradient_checkpointing
    lora_cfg = lora_params = lora_step = None
    if training_args.lora_enable:
        if cfg.language_model_type != "llama":
            raise ValueError("LoRA targets the LLaMA backbone's matrices (the JAX package's "
                             f"LLAMA_TARGETS), not {cfg.language_model_type!r}")
        lora_cfg = lora_lib.LoraConfig(r=training_args.lora_r, alpha=training_args.lora_alpha,
                                       dropout=training_args.lora_dropout)
        if training_args.bits in (4, 8):
            params = quantize_llava_params(params, "llama", bits=training_args.bits)
        lora_params = init_lora(params["language_model"], lora_cfg,
                                torch.Generator(device=device).manual_seed(1))
        opt_cfg = dataclasses.replace(opt_cfg, train_language_model=False)
    if mesh is not None:
        # every rank built the same tree: each keeps its shards (quantized
        # leaves by _quant_specs), the adapters replicated
        params = step_lib.place_params(params, mesh, cfg)
        if lora_params is not None:
            lora_params = tree_map(lambda x: distribute_tensor(x, mesh, [Replicate()] * mesh.ndim),
                                   lora_params)
    stacked_params = params
    params = per_layer(params)  # views: updates reach stacked_params
    if lora_params is not None:
        lora_step = _lora_step_fn(params, cfg, lora_cfg, lora_lib.lora_per_layer(lora_params),
                                  training_args.learning_rate, remat, accum, mesh)
        opt_state = None
    else:
        optimizer = build_optimizer(params, opt_cfg)
        opt_state = optimizer.init(params)
        step_fn = step_lib.make_train_step(cfg, optimizer, remat=remat, accum_steps=accum,
                                           mesh=mesh)

    # resume --------------------------------------------------------------
    start_step, epoch, start = 0, 0, 0
    if (training_args.resume and lora_params is None   # a LoRA run saves no state
            and not training_args.save_only_model):
        latest = ckpt_lib.latest_checkpoint(training_args.output_dir)
        if latest is not None:
            state, start_step = ckpt_lib.restore_train_state(latest, params, opt_state)
            opt_state = state["opt_state"]
            epoch, start = ckpt_lib.data_position(latest, batch_size * accum)
            logger.info(f"resumed from {latest} at step {start_step}, epoch {epoch}, "
                        f"sample {start} of its order")

    # sampler -------------------------------------------------------------
    sampler = None
    if training_args.group_by_modality_length:
        sampler = LengthGroupedSampler(batch_size, world_size=1,
                                       lengths=dataset.modality_lengths,
                                       group_by_modality=True, seed=training_args.seed)

    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0

    def epoch_batches(order, start):
        """``(arrays, sample_ids, end)`` from ``order[start:]``: padded
        per-sample rows, or (``--pack-sequences``) fixed-shape rows packing a
        contiguous run of the order; ``end`` is the index in ``order`` of
        the first sample after them."""
        if training_args.pack_sequences:
            from llava_plus_torch.data.packing import pack_instances

            i = start
            while i < len(order):
                ids = order[i:i + batch_size * 16]
                arrays, consumed = pack_instances(
                    [dataset[j] for j in ids], rows=batch_size,
                    max_len=training_args.model_max_length,
                    num_patches=cfg.num_image_tokens, image_size=cfg.vision.image_size,
                    max_images_per_row=training_args.pack_max_images, pad_token_id=pad_id)
                if consumed == 0:
                    break
                i += consumed
                yield arrays, ids[:consumed], i
            return
        for i in range(start, len(order) - batch_size + 1, batch_size):
            ids = order[i:i + batch_size]
            yield (collate_batch([dataset[j] for j in ids], num_patches=cfg.num_image_tokens,
                                 max_len=training_args.model_max_length,
                                 image_size=cfg.vision.image_size, pad_token_id=pad_id),
                   ids, i + batch_size)

    def grouped_batches(order, start):
        """Stacked [accum, B, ...] for gradient accumulation (the ragged
        epoch tail is dropped), with their sample ids and end."""
        if accum == 1:
            yield from epoch_batches(order, start)
            return
        buf = []
        for arrays, ids, end in epoch_batches(order, start):
            buf.append((arrays, ids))
            if len(buf) == accum:
                yield (stack_micro_batches([a for a, _ in buf], pad_id,
                                           training_args.model_max_length),
                       [j for _, ids in buf for j in ids], end)
                buf = []

    # loop ----------------------------------------------------------------
    step = start_step
    rng = np.random.default_rng(training_args.seed)
    for _ in range(epoch):   # the orders of the epochs a resumed run has trained
        rng.permutation(len(dataset))
    position = {"epoch": epoch, "index": start}   # of the first sample not trained on
    t_last = time.perf_counter()
    while step < total_steps:
        if sampler is not None:
            sampler.set_epoch(epoch)
            order = list(iter(sampler))
        else:
            order = list(rng.permutation(len(dataset)))
        for arrays, ids, end in _prefetched(grouped_batches(order, start),
                                            training_args.prefetch_batches):
            if step >= total_steps:
                break
            batch = MultimodalBatch(**{k: torch.from_numpy(np.asarray(v)).to(device)
                                       for k, v in arrays.items()})
            if mesh is not None:
                batch = step_lib.place_batch(batch, mesh, accum)
            if lora_step is not None:
                metrics = lora_step(batch)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            step += 1
            position = {"epoch": epoch, "index": end}
            if on_data is not None:
                on_data(step, epoch, [int(j) for j in ids])
            if step % training_args.logging_steps == 0 or on_step is not None:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                dt, t_last = now - t_last, now
                logger.info(f"step {step}/{total_steps} loss={m['loss']:.4f} "
                            f"acc={m['accuracy']:.3f} gnorm={m['grad_norm']:.2f} ({dt:.2f}s)")
                if on_step is not None:
                    on_step(step, m, dt, arrays)
            if step % training_args.save_steps == 0:
                _save(params, opt_state, step, cfg, training_args, model_args, tokenizer,
                      lora_params, lora_cfg, rank=rank, position=position)
        epoch, start = epoch + 1, 0

    _save(params, opt_state, step, cfg, training_args, model_args, tokenizer, lora_params,
          lora_cfg, final=True, rank=rank, position=position)
    return stacked_params, cfg


def _save(params, opt_state, step, cfg, training_args, model_args, tokenizer,
          lora_params=None, lora_cfg=None, final: bool = False, rank: int = 0,
          position=None):
    """The saves of a step, called on every rank. The exports (the adapter,
    the LoRA adapters, the final HF checkpoint) gather their trees to rank 0
    leaf by leaf (``checkpoint.gathered``), which writes them; the training
    state is written by every rank of a mesh, each its own shards, with the
    data ``position`` the run resumes from."""
    out_dir = Path(training_args.output_dir)
    if model_args.tune_mm_mlp_adapter:
        # adapter-only save
        proj = {"mm_projector": ckpt_lib.gathered(params["mm_projector"], rank)}
        if rank == 0:
            ckpt_lib.export_mm_projector_bin(
                proj, out_dir / f"{ckpt_lib.CKPT_PREFIX}{step}" / "mm_projector.bin")
            if final:
                ckpt_lib.export_mm_projector_bin(proj, out_dir / "mm_projector.bin")
        return
    if lora_params is not None:
        proj = ckpt_lib.gathered(params["mm_projector"], rank)
        lora_params = ckpt_lib.gathered(lora_params, rank)
        if rank == 0:
            out_dir.mkdir(parents=True, exist_ok=True)
            lora_lib.save_peft_adapter(lora_params, lora_cfg, out_dir,
                                       ckpt_lib.projector_state_dict_from_params(proj))
            cfg.save(out_dir / "config.json")
        return
    if not (final and training_args.save_only_model):
        ckpt_lib.save_train_state(out_dir, step, params,
                                  None if training_args.save_only_model else opt_state, cfg,
                                  position)
    if final:
        params = ckpt_lib.gathered(params, rank)
        if rank == 0:
            ckpt_lib.export_hf_llava(params, cfg, out_dir / "hf_export", tokenizer)


def build_parser() -> argparse.ArgumentParser:
    """The trainer's flags: every field of the three argument dataclasses."""
    parser = argparse.ArgumentParser()
    for dc in (ModelArguments, DataArguments, TrainingArguments):
        for f in dataclasses.fields(dc):
            # both --snake-case and the reference recipes' --snake_case
            names = ["--" + f.name.replace("_", "-")]
            if "_" in f.name:
                names.append("--" + f.name)
            ann = str(f.type)
            if f.type == bool or isinstance(f.default, bool):
                parser.add_argument(*names, type=lambda x: x.lower() == "true",
                                    default=f.default)
            elif f.default is not None:
                parser.add_argument(*names, type=type(f.default), default=f.default)
            else:
                # Optional[...]: the scalar type from the annotation, so
                # "--max-steps 3" parses as an int
                typ = int if "int" in ann else float if "float" in ann else str
                parser.add_argument(*names, type=typ, default=None)
    return parser


def main(argv=None, **hooks):
    """The trainer's command line; ``hooks`` (``build_model``, ``on_step``
    ...) go to :func:`train`, whose result this returns."""
    args = build_parser().parse_args(argv)

    def pick(dc):
        return dc(**{f.name: getattr(args, f.name) for f in dataclasses.fields(dc)})

    return train(pick(ModelArguments), pick(DataArguments), pick(TrainingArguments), **hooks)


if __name__ == "__main__":
    main()
