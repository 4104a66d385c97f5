"""Model configurations: the JAX package's framework-free dataclasses, used
as they are so that both packages read one definition."""

from llava_plus_tpu.models.configs import (  # noqa: F401
    LLAVA_15_7B,
    ClipVisionConfig,
    LlamaConfig,
    LlavaConfig,
    tiny_llava_config,
)
