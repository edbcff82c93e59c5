"""hac.mfu: the CRF model step's share of the card's peak in a call: the
frozen FLOP count of a window through the whole model (``frozen.crf_work``:
12.14 GFLOP at Bonito's HAC widths and 4,000 samples; its stem runs at the
input's rate, which ``frozen.work``'s output-rate count cannot express) times
the windows computed in the traced window (the wrap padding of each call's
last batch included), over the window, against the peak of the cell's
precision (``_common.MODEL_PEAK``): dense TF32's 495 TFLOP/s for the float32
cell ``bonito_hac.call``, which runs float32 GEMMs on the CUDA cores (TF32
off), and bf16's 989 TFLOP/s for a bf16 cell."""

from benchmark.frozen import crf_work as W
from benchmark.metrics._common import MODEL_PEAK


def read(ctx):
    t = ctx.trace
    windows = ctx.work.get("windows", 0.0)
    if t is None or t.window_s <= 0 or windows <= 0:
        return None
    flops = W.model_flops_per_window(ctx.config, ctx.traffic["segment_len"]) * windows
    return 100.0 * flops / t.window_s / MODEL_PEAK[ctx.traffic["precision"]]
