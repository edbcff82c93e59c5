"""hac_lstm_roofline: the HAC model's five single-direction LSTM layers
(``ops/lstm.py`` -> ``csrc/bilstm.cu``, ``lstm_infer_kernel``) against their
roofline: each layer's recurrence over the frames the rows are active on at
the peak of the cell's precision, or its bytes at 3.35 TB/s
(``frozen.crf_work.lstm_work``), whichever is longer, over the device time of
``lstm_infer_kernel``, found by name in the trace. The input projections are
``torch.matmul`` calls outside the kernel and are not counted here."""

from benchmark.frozen import crf_work as W
from benchmark.metrics._common import ACT_BYTES, MODEL_PEAK, kernel_share

KERNELS = ("lstm_infer_kernel",)


def read(ctx):
    batches = ctx.work.get("batches", 0.0)
    if batches <= 0:
        return None
    cfg, prec = ctx.config, ctx.traffic["precision"]
    w = W.lstm_work(cfg["layers"], cfg["features"], ctx.work["frames"] / batches,
                    ctx.work["frames_padded"] / batches, ACT_BYTES[prec])
    # one launch a layer: each layer's bound is its own
    per_layer = W.roofline_seconds(w["flops"] / cfg["layers"], w["bytes"] / cfg["layers"],
                                   MODEL_PEAK[prec])
    return kernel_share(ctx, KERNELS, per_layer * cfg["layers"] * batches)
