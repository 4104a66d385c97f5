"""% of their roofline that the int8 products reach (csrc/quant_matmul.cu:
int8_stream_kernel and int8_wgmma_kernel; 64 slots put decode steps on the
wgmma kernel). Least time: each decode step reads every int8 matrix and its
f32 column scales once (bytes over HBM bandwidth; the decode step's 2 * slots
* K * N FLOPs take less), and the window's prefills need 2 * real rows * K * N
FLOPs (over the bf16 peak), or each prefill dispatch's one read of the
weights, whichever is longer. Over the kernels' device time."""

from portbench import counts, measure
from portbench.shares import kernel_s


def read(run):
    t = kernel_s(run, "int8_wgmma_kernel", "int8_stream_kernel")
    if not t:
        return None
    cfg, c, pk = run.cfg, run.out["counters"], run.peak
    w = counts.int8_weight_bytes(cfg)
    slots = run.cell["engine"]["max_slots"]
    decode = c["decode_steps"] * max(w / pk["hbm_bytes_per_s"],
                                     2 * slots * counts.int8_macs(cfg) / pk["bf16_flops"])
    rows = sum(measure.window_prefills(run.out))
    layers = counts.layer_macs(cfg) * counts.lm_dims(cfg)["L"]
    prefill = max(c["prefill_dispatches"] * w / pk["hbm_bytes_per_s"],
                  2 * rows * layers / pk["bf16_flops"])
    return 100.0 * (decode + prefill) / t
