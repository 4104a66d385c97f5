"""mfu.tokens' FLOPs over the device-busy seconds x peak: at a fixed offered
rate a share of the wall clock would be fixed by the rate."""

from portbench.shares import mfu_over_busy as read  # noqa: F401
