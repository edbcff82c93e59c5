"""hac_stem_roofline: Bonito's conv stem on the fused conv kernel (``ops/conv_bn.py``
-> ``csrc/conv_bn.cu``; three launches a batch: k 5, 1 -> 4 and k 5, 4 -> 16 at the
input's rate, k 19, 16 -> 384 at stride 5, the last two through the kernels' swish
instances) against its roofline: ``frozen.work.conv_bn_work`` of each launch of the
configuration's ``stem`` (the products at the peak of the cell's precision, or the
bytes at 3.35 TB/s, whichever is longer), over the device time of the kernels of
``csrc/conv_bn.cu``, found by name in the trace: in this cell only the stem launches
them."""

from benchmark.frozen import work as W
from benchmark.metrics._common import ACT_BYTES, MODEL_PEAK, kernel_share

KERNELS = ("conv_bn_mma_kernel", "conv_bn_direct_kernel", "moments_reduce_kernel",
           "colsum_reduce_kernel", "sums_from_colsum_kernel")


def read(ctx):
    batches = ctx.work.get("batches", 0.0)
    if batches <= 0:
        return None
    prec, batch = ctx.traffic["precision"], ctx.traffic["batch_size"]
    t, ideal = ctx.traffic["segment_len"], 0.0
    for k, c_in, c_out, stride in ctx.config["stem"]:
        t_out = -(-t // stride)  # k odd, padded k // 2 on both sides
        w = W.conv_bn_work([[k, c_in, c_out, t, t_out, 1]], batch, ACT_BYTES[prec],
                           ACT_BYTES[prec])
        ideal += W.roofline_seconds(w["flops"], w["bytes"], MODEL_PEAK[prec])
        t = t_out
    return kernel_share(ctx, KERNELS, ideal * batches)
