"""conv_bn_roofline: the fused conv + batch-norm layer (``ops/conv_bn.py`` ->
``csrc/conv_bn.cu``) against its roofline: for every batch of the traced
window, the least time of each launch of the configuration's conv list
(``frozen.work.conv_bn_work``: the products at the peak of the cell's
precision, or the bytes at 3.35 TB/s, whichever is longer), over the device
time of the kernels of ``csrc/conv_bn.cu``, found by name in the trace."""

from benchmark.frozen import work as W
from benchmark.metrics._common import ACT_BYTES, MODEL_PEAK, conv_launches, kernel_share

KERNELS = ("conv_bn_mma_kernel", "conv_bn_direct_kernel", "moments_reduce_kernel",
           "colsum_reduce_kernel", "sums_from_colsum_kernel")


def read(ctx):
    prec = ctx.traffic["precision"]
    batch = ctx.traffic["batch_size"]
    ideal = 0.0
    for launch in conv_launches(ctx):
        w = W.conv_bn_work([launch], batch, ACT_BYTES[prec], ACT_BYTES[prec])
        ideal += W.roofline_seconds(w["flops"], w["bytes"], MODEL_PEAK[prec])
    return kernel_share(ctx, KERNELS, ideal * ctx.work.get("batches", 0.0))
