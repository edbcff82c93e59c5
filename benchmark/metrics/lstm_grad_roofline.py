"""lstm_grad_roofline: the training LSTM kernels (``ops/lstm_grad.py`` ->
``csrc/lstm_grad.cu``: the forward with its residuals, the BPTT backward and
the dwh pass) against their roofline: ``frozen.work.lstm_grad_work`` of
every step of the traced window at 495 TFLOP/s or 3.35 TB/s, whichever is
longer, over the device time of those kernels, found by name in the
trace."""

from benchmark.frozen import work as W
from benchmark.metrics._common import MODEL_PEAK, frames_out, kernel_share

KERNELS = ("lstm_fwd_kernel", "lstm_bwd_kernel", "lstm_dwh_partial_kernel",
           "lstm_dwh_reduce_kernel")


def read(ctx):
    steps = ctx.work.get("batches", 0.0)
    if steps <= 0:
        return None
    lstm = ctx.config["lstm"]
    w = W.lstm_grad_work(lstm["layers"], lstm["hidden"], ctx.work["frames"] / steps,
                         ctx.traffic["batch_size"] * frames_out(ctx))
    ideal = W.roofline_seconds(w["flops"], w["bytes"], MODEL_PEAK[ctx.traffic["precision"]])
    return kernel_share(ctx, KERNELS, ideal * steps)
