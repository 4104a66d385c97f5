"""% of its roofline that the flash forward reaches (csrc/flash_fwd.cu): the
causal attention FLOPs of the window's prefills at their real lengths (not
their buckets) over the bf16 peak, over the kernel's device time."""

from portbench import counts, measure
from portbench.shares import kernel_s


def read(run):
    t = kernel_s(run, "flash_fwd_kernel")
    lens = measure.window_prefills(run.out)
    if not t or not lens:
        return None
    flops = sum(counts.prefill_attention_flops(run.cfg, n) for n in lens)
    return 100.0 * flops / run.peak["bf16_flops"] / t
