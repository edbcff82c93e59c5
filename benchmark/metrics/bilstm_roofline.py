"""bilstm_roofline: the BiLSTM inference layers (``ops/bilstm.py`` ->
``csrc/bilstm.cu``) against their roofline: the recurrences' products over
the frames the rows are active on, at the peak of the cell's precision, or
their bytes at 3.35 TB/s (``frozen.work.bilstm_work``), over the device time
of ``lstm_infer_kernel``, found by name in the trace. The input projections
are ``torch.matmul`` calls outside the kernel and are not counted here."""

from benchmark.frozen import work as W
from benchmark.metrics._common import ACT_BYTES, MODEL_PEAK, frames_out, kernel_share

KERNELS = ("lstm_infer_kernel",)


def read(ctx):
    prec = ctx.traffic["precision"]
    lstm = ctx.config["lstm"]
    batches = ctx.work.get("batches", 0.0)
    if batches <= 0:
        return None
    per_batch_frames = ctx.work["frames"] / batches
    w = W.bilstm_work(lstm["layers"], lstm["hidden"], per_batch_frames,
                      ctx.traffic["batch_size"] * frames_out(ctx), ACT_BYTES[prec])
    # one launch a layer, both directions: the layer's bound is its own
    per_layer = W.roofline_seconds(w["flops"] / lstm["layers"], w["bytes"] / lstm["layers"],
                                   MODEL_PEAK[prec])
    return kernel_share(ctx, KERNELS, per_layer * lstm["layers"] * batches)
