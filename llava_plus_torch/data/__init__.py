"""Tokenizer and image preprocessing: the port's own copies of the JAX
package's framework-free implementations."""

from llava_plus_torch.data.debug_tokenizer import DebugTokenizer  # noqa: F401
from llava_plus_torch.data.image_processing import ClipImageProcessor  # noqa: F401
