"""Tokenizer and image preprocessing: the JAX package's framework-free
implementations, used as they are."""

from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer  # noqa: F401
from llava_plus_tpu.data.image_processing import ClipImageProcessor  # noqa: F401
