"""% of its roofline that the int8 wgmma kernel reaches on prefill rows
(csrc/quant_matmul.cu, int8_wgmma_kernel; at 32 slots the decode rows and
the prefill's head rows take the stream kernel): 2 * real rows * K * N of
the decoder's products in the window's prefills, over the bf16 peak, over
the kernel's device time."""

from portbench import counts, measure
from portbench.shares import kernel_s


def read(run):
    t = kernel_s(run, "int8_wgmma_kernel")
    rows = sum(measure.window_prefills(run.out))
    if not t or not rows:
        return None
    flops = 2 * rows * counts.layer_macs(run.cfg) * counts.lm_dims(run.cfg)["L"]
    return 100.0 * flops / run.peak["bf16_flops"] / t
