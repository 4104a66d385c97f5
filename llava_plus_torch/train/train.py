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
and saves the training state and a final HF export. The trainer holds the
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

Not ported yet, each raising ``NotImplementedError``: loading a checkpoint
(``--model-name-or-path``, ``--pretrain-mm-mlp-adapter``; ROADMAP Queue 1
item 4) and the (dp, fsdp, tp) mesh (``--dp``, ``--fsdp-axis``, ``--tp``
other than 1; item 10).
"""

from __future__ import annotations

import argparse
import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

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
from llava_plus_torch.models.convert import per_layer
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.ops.quant import quantize_llava_params
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


def _unported(model_args: ModelArguments, training_args: TrainingArguments):
    if ((model_args.model_name_or_path is not None and not model_args.tiny_debug_model)
            or model_args.pretrain_mm_mlp_adapter):
        raise NotImplementedError("loading a checkpoint (--model-name-or-path, "
                                  "--pretrain-mm-mlp-adapter) is not ported yet: ROADMAP "
                                  "Queue 1 item 4")
    if training_args.dp != 1 or training_args.tp != 1 or training_args.fsdp_axis not in (None, 1):
        raise NotImplementedError("the (dp, fsdp, tp) mesh is not ported yet: one card "
                                  "(ROADMAP Queue 1 item 10)")


def build_model(model_args: ModelArguments, dtype: torch.dtype, device):
    """(params, cfg, tokenizer): the tiny debug model of ``tiny_debug_arch``
    (LLaMA or MPT) with random weights from seed 0, made on ``device`` in
    the stacked layout."""
    from llava_plus_torch.data.debug_tokenizer import DebugTokenizer
    from llava_plus_torch.models import llava as llava_model

    mpt = model_args.tiny_debug_arch == "mpt"
    cfg = tiny_llava_mpt_config() if mpt else tiny_llava_config()
    params = llava_model.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                     device, dtype)
    tok = DebugTokenizer(vocab_size=cfg.mpt.vocab_size if mpt else cfg.text.vocab_size)
    if mpt:
        tok.bos_token_id = None  # MPT tokenizers carry no BOS
    return params, cfg, tok


def _lora_step_fn(params, cfg, lora_cfg: lora_lib.LoraConfig, lora_layers, learning_rate,
                  remat: bool, accum: int):
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

    def produce():
        try:
            for item in items:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(done)
        except BaseException as e:  # surfaced in the loop
            q.put(e)

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
          on_step: Optional[Callable] = None):
    """Run the recipe; returns (params in the stacked layout, cfg); with
    LoRA the base as it was, and the trained adapters are what the save
    writes. ``build_model(model_args, dtype, device) -> (params, cfg,
    tokenizer)`` gives the initial weights, ``init_lora(lm_params, lora_cfg,
    generator)`` the initial stacked adapters (updated in place by the
    training); ``on_step(step, metrics, seconds, batch)``, if given, sees
    every step's metrics (floats), its host time and the batch arrays."""
    _unported(model_args, training_args)
    logger = build_logger("train", "train.log")
    device = torch.device(training_args.device)
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    params, cfg, loaded_tokenizer = build_model(model_args, dtype, device)
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
    if model_args.vision_tower:
        image_processor = processor_for_vision_tower(model_args.vision_tower)
    else:
        image_processor = ClipImageProcessor(shortest_edge=cfg.vision.image_size,
                                             crop_size=cfg.vision.image_size)
    dataset = make_supervised_dataset(tokenizer, data_cfg, image_processor, conv)
    logger.info(f"train_dataset size: {len(dataset)}")

    batch_size = training_args.per_device_train_batch_size
    steps_per_epoch = max(len(dataset) // batch_size, 1)
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
    accum = max(int(training_args.gradient_accumulation_steps), 1)
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
    stacked_params = params
    params = per_layer(params)  # views: updates reach stacked_params
    if lora_params is not None:
        lora_step = _lora_step_fn(params, cfg, lora_cfg, lora_lib.lora_per_layer(lora_params),
                                  training_args.learning_rate, remat, accum)
        opt_state = None
    else:
        optimizer = build_optimizer(params, opt_cfg)
        opt_state = optimizer.init(params)
        step_fn = step_lib.make_train_step(cfg, optimizer, remat=remat, accum_steps=accum)

    # resume --------------------------------------------------------------
    start_step = 0
    if training_args.resume and lora_params is None:   # a LoRA run saves no state
        latest = ckpt_lib.latest_checkpoint(training_args.output_dir)
        if latest is not None:
            state, start_step = ckpt_lib.restore_train_state(latest, params, opt_state)
            opt_state = state["opt_state"]
            logger.info(f"resumed from {latest} at step {start_step}")

    # sampler -------------------------------------------------------------
    sampler = None
    if training_args.group_by_modality_length:
        sampler = LengthGroupedSampler(batch_size, world_size=1,
                                       lengths=dataset.modality_lengths,
                                       group_by_modality=True, seed=training_args.seed)

    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0

    def epoch_batches(order):
        """Padded per-sample rows, or (``--pack-sequences``) fixed-shape rows
        packing a contiguous run of the sampler order."""
        if training_args.pack_sequences:
            from llava_plus_torch.data.packing import pack_instances

            i = 0
            while i < len(order):
                window = [dataset[j] for j in order[i:i + batch_size * 16]]
                arrays, consumed = pack_instances(
                    window, rows=batch_size, max_len=training_args.model_max_length,
                    num_patches=cfg.num_image_tokens, image_size=cfg.vision.image_size,
                    max_images_per_row=training_args.pack_max_images, pad_token_id=pad_id)
                if consumed == 0:
                    break
                i += consumed
                yield arrays
            return
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield collate_batch([dataset[j] for j in order[i:i + batch_size]],
                                num_patches=cfg.num_image_tokens,
                                max_len=training_args.model_max_length,
                                image_size=cfg.vision.image_size, pad_token_id=pad_id)

    def grouped_batches(order):
        """Stacked [accum, B, ...] for gradient accumulation (the ragged
        epoch tail is dropped)."""
        if accum == 1:
            yield from epoch_batches(order)
            return
        buf = []
        for arrays in epoch_batches(order):
            buf.append(arrays)
            if len(buf) == accum:
                yield stack_micro_batches(buf, pad_id, training_args.model_max_length)
                buf = []

    # loop ----------------------------------------------------------------
    step = start_step
    rng = np.random.default_rng(training_args.seed)
    t_last = time.perf_counter()
    while step < total_steps:
        order = (list(iter(sampler)) if sampler is not None
                 else list(rng.permutation(len(dataset))))
        for arrays in _prefetched(grouped_batches(order), training_args.prefetch_batches):
            if step >= total_steps:
                break
            batch = MultimodalBatch(**{k: torch.from_numpy(np.asarray(v)).to(device)
                                       for k, v in arrays.items()})
            if lora_step is not None:
                metrics = lora_step(batch)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            step += 1
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
                      lora_params, lora_cfg)

    _save(params, opt_state, step, cfg, training_args, model_args, tokenizer, lora_params,
          lora_cfg, final=True)
    return stacked_params, cfg


def _save(params, opt_state, step, cfg, training_args, model_args, tokenizer,
          lora_params=None, lora_cfg=None, final: bool = False):
    out_dir = Path(training_args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if model_args.tune_mm_mlp_adapter:
        # adapter-only save
        ckpt_lib.export_mm_projector_bin(
            params, out_dir / f"{ckpt_lib.CKPT_PREFIX}{step}" / "mm_projector.bin")
        if final:
            ckpt_lib.export_mm_projector_bin(params, out_dir / "mm_projector.bin")
        return
    if lora_params is not None:
        extra = ckpt_lib.projector_state_dict_from_params(params["mm_projector"])
        lora_lib.save_peft_adapter(lora_params, lora_cfg, out_dir, extra)
        cfg.save(out_dir / "config.json")
        return
    ckpt_lib.save_train_state(out_dir, step, params, opt_state, cfg)
    if final:
        ckpt_lib.export_hf_llava(params, cfg, out_dir / "hf_export", tokenizer)


def main(argv=None):
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
    args = parser.parse_args(argv)

    def pick(dc):
        return dc(**{f.name: getattr(args, f.name) for f in dataclasses.fields(dc)})

    train(pick(ModelArguments), pick(DataArguments), pick(TrainingArguments))


if __name__ == "__main__":
    main()
