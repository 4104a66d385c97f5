"""Framework-wide constants: the port's own copy of
``llava_plus_tpu/constants.py``.

Parity target: reference ``llava/constants.py:1-13`` — the sentinel values are
part of the on-disk data format (training JSON, tokenized sequences) and the
serving protocol, so they must match the reference exactly.
"""

# Serving control plane (seconds). Reference: llava/constants.py:1-2.
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

LOGDIR = "."

# Model constants. Reference: llava/constants.py:7-13.
IGNORE_INDEX = -100          # label value masked out of the loss
IMAGE_TOKEN_INDEX = -200     # sentinel token id marking an image splice point
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
