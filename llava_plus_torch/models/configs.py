"""Model configuration dataclasses (the port's own copy of
``llava_plus_tpu/models/configs.py``).

Replaces the reference's mutable-HF-config-as-registry pattern
(``llava/model/llava_arch.py:48-68``) with frozen dataclasses that fully
describe the compiled program: static shapes, head layouts, projector type.
Serialized to/from ``config.json`` for checkpoint round-trips, including
import from HF LLaVA checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower (ref: HF CLIPVisionModel wrapped by
    llava/model/multimodal_encoder/clip_encoder.py)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # LLaVA selects hidden layer -2 and drops the CLS token ("patch" feature)
    # (ref clip_encoder.py:29-37; scripts pass --mm_vision_select_layer -2).
    select_layer: int = -2
    select_feature: str = "patch"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


CLIP_VIT_L_336 = ClipVisionConfig()
CLIP_VIT_L_224 = ClipVisionConfig(image_size=224)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """LLaMA/Vicuna decoder config (GQA-ready; MHA when kv_heads == heads)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # HF `rope_scaling`: {"type": "linear"|"dynamic", "factor": f}. linear
    # divides positions by `factor`; dynamic is NTK-aware theta rescaling
    # (applied statically at the scaled context length — cache-friendly,
    # unlike HF's per-forward recompute which invalidates cached K).
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


LLAMA_7B = LlamaConfig()
LLAMA_13B = LlamaConfig(
    hidden_size=5120, intermediate_size=13824,
    num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=40,
)


@dataclasses.dataclass(frozen=True)
class MptConfig:
    """MPT decoder config (ref llava/model/language_model/mpt/configuration_mpt.py):
    ALiBi or learned positions, MQA option, prefix-LM option."""

    vocab_size: int = 50432
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    # attn_config equivalents
    alibi: bool = True
    alibi_bias_max: int = 8
    multiquery: bool = False          # MQA: 1 shared KV head
    prefix_lm: bool = False
    attn_uses_sequence_id: bool = False
    clip_qkv: Optional[float] = None
    qk_ln: bool = False
    softmax_scale: Optional[float] = None
    no_bias: bool = True
    learned_pos_emb: bool = False
    layer_norm_eps: float = 1e-5
    logit_scale: Optional[float] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return 1 if self.multiquery else self.n_heads


MPT_7B = MptConfig()


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    """Full multimodal model: vision tower + projector + language model.

    ``language_model_type`` selects the decoder family ("llama" | "mpt"),
    mirroring LlavaLlamaForCausalLM / LlavaMPTForCausalLM (ref
    llava/model/language_model/llava_llama.py, llava_mpt.py).
    """

    language_model_type: str = "llama"
    text: LlamaConfig = LLAMA_7B
    mpt: Optional[MptConfig] = None
    vision: ClipVisionConfig = CLIP_VIT_L_336
    # mm_projector_type: "linear", "mlpNx_gelu", "identity"
    # (ref llava/model/multimodal_projector/builder.py:33-51)
    mm_projector_type: str = "mlp2x_gelu"
    mm_hidden_size: int = 1024
    image_aspect_ratio: Optional[str] = "pad"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    max_sequence_length: int = 2048

    @property
    def hidden_size(self) -> int:
        if self.language_model_type == "mpt":
            return self.mpt.d_model
        return self.text.hidden_size

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "LlavaConfig":
        d = json.loads(text)
        if d.get("text"):
            d["text"] = LlamaConfig(**d["text"])
        if d.get("mpt"):
            d["mpt"] = MptConfig(**d["mpt"])
        if d.get("vision"):
            d["vision"] = ClipVisionConfig(**d["vision"])
        return cls(**d)

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "LlavaConfig":
        return cls.from_json(Path(path).read_text())


LLAVA_15_7B = LlavaConfig()
LLAVA_15_13B = LlavaConfig(text=LLAMA_13B)
# LLaVA-MPT-7B as ``hf_import.llava_config_from_hf_dir`` reads the config of
# liuhaotian/LLaVA-Lightning-MPT-7B-preview: mosaicml/mpt-7b-chat's decoder,
# CLIP ViT-L/14 at 224 px (256 patches), a linear projector, image start/end
# tokens.
LLAVA_MPT_7B = LlavaConfig(
    language_model_type="mpt", mpt=MPT_7B, vision=CLIP_VIT_L_224,
    mm_projector_type="linear", mm_use_im_start_end=True,
)


def tiny_llava_mpt_config() -> "LlavaConfig":
    """Tiny MPT-backbone llava for tests (ALiBi, MQA-free 4-head)."""
    return LlavaConfig(
        language_model_type="mpt",
        mpt=MptConfig(
            vocab_size=512, d_model=64, n_layers=2, n_heads=4,
            expansion_ratio=2, max_seq_len=256, alibi=True,
        ),
        vision=ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=28, patch_size=14,
        ),
        mm_hidden_size=32,
        max_sequence_length=256,
    )


def tiny_llava_config(
    vocab_size: int = 512,
    hidden_size: int = 64,
    vision_hidden: int = 32,
    image_size: int = 28,
    patch_size: int = 14,
    num_layers: int = 2,
) -> LlavaConfig:
    """A tiny config for tests (fast CPU compile, real code paths)."""
    return LlavaConfig(
        text=LlamaConfig(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=hidden_size * 2, num_hidden_layers=num_layers,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512,
        ),
        vision=ClipVisionConfig(
            hidden_size=vision_hidden, intermediate_size=vision_hidden * 2,
            num_hidden_layers=num_layers, num_attention_heads=2,
            image_size=image_size, patch_size=patch_size,
        ),
        mm_hidden_size=vision_hidden,
        max_sequence_length=256,
    )
