"""% of the measured window in which no device operation ran: the device
seconds a model FLOP took in the profiled window (the union of its device
intervals over its work), times the measured window's FLOPs a second."""

from portbench.shares import idle_share as read  # noqa: F401
