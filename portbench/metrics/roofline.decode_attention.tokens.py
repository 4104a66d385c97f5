"""% of its roofline that the decode kernel reaches (csrc/decode_attention.cu,
decode_kernel). Bytes: for each decode-made token delivered in the window,
the int8 keys and values (with their f32 scales) of every position up to its
query's, in every layer, and its bf16 query and output; over HBM bandwidth,
over the kernel's device time."""

from portbench import counts, measure
from portbench.shares import kernel_s


def read(run):
    t = kernel_s(run, "decode_kernel")
    pos = measure.decode_positions(run.out)
    if not t or not pos:
        return None
    need = sum(counts.decode_attention_bytes(run.cfg, p) for p in pos)
    return 100.0 * need / run.peak["hbm_bytes_per_s"] / t
