"""% of the kernels' device time in elementwise work, copies and casts:
kernels that are neither a GEMM (cuBLAS or the port's quantized products)
nor attention, by the names in portbench/kernels.json."""

from portbench.shares import elementwise_share as read  # noqa: F401
