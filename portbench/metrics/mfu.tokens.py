"""The whole step's share of the chip's bf16 peak: model FLOPs of the
window's prefills (vision tower, decoder at the real prompt lengths, causal
attention, the head at the last row) and decode-made tokens (decoder, head,
attention over the cache), over window seconds x peak."""

from portbench.shares import mfu_over_window as read  # noqa: F401
