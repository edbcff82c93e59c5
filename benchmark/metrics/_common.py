"""Shared arithmetic of the per-layer readers (not a metric itself)."""

from __future__ import annotations

from benchmark import weights
from benchmark.frozen import work as W

# the peak a cell's model products are held to, by the precision it states
MODEL_PEAK = {"bf16": W.PEAKS["bf16"], "fp32": W.PEAKS["tf32"]}
ACT_BYTES = {"bf16": 2, "fp32": 4}


def frames_out(ctx) -> int:
    return -(-ctx.traffic["segment_len"] // ctx.config["stride"])


def idle_share(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def model_share(ctx, passes: float = 1.0):
    """The model's FLOPs over the windows computed in the traced window, as a
    share of the peak of the cell's precision: ``passes`` 1 for inference,
    3 for a training step (forward and the two products of the backward)."""
    t = ctx.trace
    windows = ctx.work.get("windows", 0.0)
    if t is None or t.window_s <= 0 or windows <= 0:
        return None
    flops = passes * W.model_flops_per_window(weights.shapes(ctx.config),
                                              frames_out(ctx)) * windows
    return 100.0 * flops / t.window_s / MODEL_PEAK[ctx.traffic["precision"]]


def kernel_share(ctx, names, ideal_s):
    """The least time the work needs over the device time of the kernels
    named, as a share; None where none of them ran."""
    if ctx.trace is None:
        return None
    spent = ctx.trace.seconds_of(names)
    if spent <= 0 or ideal_s <= 0:
        return None
    return 100.0 * ideal_s / spent


def conv_launches(ctx):
    """The config's conv launches as [k, c_in, c_out, t_in, t_out, terms]."""
    seg = ctx.traffic["segment_len"]
    out = []
    for k, c_in, c_out, in_stride, stride, terms in ctx.config["convs"]:
        t_in = -(-seg // in_stride)
        out.append([k, c_in, c_out, t_in, -(-t_in // stride), terms])
    return out
