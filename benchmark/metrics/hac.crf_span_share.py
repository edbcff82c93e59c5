"""hac.crf_span_share: 100 x the seconds of the program's ``model.crf_decode``
spans over the seconds of its ``call.step`` spans in the traced window, from
the run's span recorder (``chiron_tpu_torch/utils/timing.py``, on only while
the window's profiler is). None where no such span was recorded.

The spans are host seconds: the three asynchronous launches of the CRF
kernels and any wait on a full launch queue. So this reads launch
back-pressure from the LSTM layers and GEMMs upstream, and moves with them;
it is not the decode's device time (about 3% of the busy time in the cell).
The decode's own share is ``crf_decode_roofline``'s, or the CRF kernels'
device seconds in the trace."""


def read(ctx):
    try:
        from chiron_tpu_torch.utils import timing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    totals = timing.span_totals()
    step = totals.get("call.step", {}).get("seconds", 0.0)
    decode = totals.get("model.crf_decode", {}).get("seconds", 0.0)
    if step <= 0 or decode <= 0:
        return None
    return 100.0 * decode / step
