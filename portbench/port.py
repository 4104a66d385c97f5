"""The seam to the system under test, ``llava_plus_torch``: its configuration
objects, its image processor and its worker backend. Nothing else of the
harness imports the port."""

from __future__ import annotations


def llava_config(cfg: dict):
    """The port's ``LlavaConfig`` for a ``portbench/configs`` file."""
    from llava_plus_torch.models.configs import (
        ClipVisionConfig, LlamaConfig, LlavaConfig, MptConfig,
    )

    v = cfg["vision"]
    vision = ClipVisionConfig(
        hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
        num_hidden_layers=v["num_hidden_layers"], num_attention_heads=v["num_attention_heads"],
        image_size=v["image_size"], patch_size=v["patch_size"],
        layer_norm_eps=v["layer_norm_eps"], select_layer=cfg["mm_vision_select_layer"])
    common = dict(vision=vision, mm_projector_type=cfg["mm_projector_type"],
                  mm_hidden_size=cfg["mm_hidden_size"],
                  mm_use_im_start_end=cfg["mm_use_im_start_end"],
                  image_aspect_ratio=cfg.get("image_aspect_ratio", "pad"))
    if cfg["family"] == "mpt":
        a = cfg["attn_config"]
        mpt = MptConfig(vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
                        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                        expansion_ratio=cfg["expansion_ratio"], max_seq_len=cfg["max_seq_len"],
                        alibi=a["alibi"], alibi_bias_max=a["alibi_bias_max"],
                        multiquery=a["attn_type"] == "multiquery_attention",
                        logit_scale=cfg["logit_scale"])
        return LlavaConfig(language_model_type="mpt", mpt=mpt,
                           max_sequence_length=cfg["max_seq_len"], **common)
    text = LlamaConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                       intermediate_size=cfg["intermediate_size"],
                       num_hidden_layers=cfg["num_hidden_layers"],
                       num_attention_heads=cfg["num_attention_heads"],
                       num_key_value_heads=cfg["num_key_value_heads"],
                       max_position_embeddings=cfg["max_position_embeddings"],
                       rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
                       tie_word_embeddings=cfg["tie_word_embeddings"])
    return LlavaConfig(language_model_type="llama", text=text,
                       max_sequence_length=cfg["max_position_embeddings"], **common)


def image_processor(cfg: dict):
    from llava_plus_torch.data.image_processing import ClipImageProcessor

    size = cfg["vision"]["image_size"]
    return ClipImageProcessor(shortest_edge=size, crop_size=size)


def backend(tree, cfg: dict, tokenizer, device, engine: dict):
    """The worker's backend (``serve.model_worker.TorchBackend``) over
    ``tree``, which it consumes, with the cell's ``engine`` settings."""
    from llava_plus_torch.serve.model_worker import TorchBackend

    return TorchBackend(tree, llava_config(cfg), tokenizer, image_processor(cfg),
                        device=device, use_engine=True, **engine)


def engine_counters(backend) -> dict:
    eng = backend.engine
    return {"decode_steps": eng.decode_steps, "prefill_dispatches": eng.prefill_dispatches,
            "prefill_requests": eng.prefill_requests}


def engine_ttfts(backend, n: int) -> list:
    """The newest ``n`` entries of the engine's TTFT deque (seconds)."""
    ttfts = list(backend.engine.ttfts)
    return ttfts[-n:] if n > 0 else []
