"""beam_roofline: the CTC prefix beam search and its traceback (``ops/beam.py``
-> ``csrc/beam.cu``) against their roofline: the search's operations over
the active frames (``frozen.work.beam_work``) at the float32 rate of the
CUDA cores (67 TFLOP/s: the search has no product for the tensor cores), or
its bytes at 3.35 TB/s, over the device time of the search and traceback
kernels, found by name in the trace."""

from benchmark.frozen import work as W
from benchmark.metrics._common import frames_out, kernel_share

KERNELS = ("beam_warp_kernel", "beam_block_kernel", "beam_traceback_kernel")


def read(ctx):
    batches = ctx.work.get("batches", 0.0)
    if batches <= 0:
        return None
    batch = ctx.traffic["batch_size"]
    w = W.beam_work(ctx.traffic["beam"], ctx.config["classes"], ctx.work["frames"] / batches,
                    batch * frames_out(ctx), batch)
    ideal = W.roofline_seconds(w["flops"], w["bytes"], W.PEAKS["fp32"])
    return kernel_share(ctx, KERNELS, ideal * batches)
