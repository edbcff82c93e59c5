"""crf_decode_roofline: the CRF decode (``ops/crf.py`` -> ``csrc/crf.cu``:
beta, the posterior and Viterbi scan, the traceback) against its roofline:
``frozen.crf_work.crf_decode_work`` of every batch of the traced window (its
bytes at 3.35 TB/s, or its operations at the CUDA cores' 67 TFLOP/s: the
decode has no product for the tensor cores), over the device time of the
decode's kernels, found by name in the trace."""

from benchmark.frozen import crf_work as W
from benchmark.metrics._common import kernel_share

KERNELS = ("crf_beta_kernel", "crf_viterbi_kernel", "crf_traceback_kernel")


def read(ctx):
    batches = ctx.work.get("batches", 0.0)
    if batches <= 0:
        return None
    w = W.crf_decode_work(4 ** ctx.config["state_len"], ctx.work["frames"] / batches,
                          ctx.traffic["batch_size"])
    ideal = W.roofline_seconds(w["flops"], w["bytes"], W.PEAKS["fp32"])
    return kernel_share(ctx, KERNELS, ideal * batches)
