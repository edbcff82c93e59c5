"""call.mfu: the model step's share of the card's peak in a call: the frozen
FLOP count of the model a window times the windows computed in the traced
window (the wrap padding of each call's last batch included), over the
window, against the peak of the cell's precision (bf16: 989 TFLOP/s)."""

from benchmark.metrics._common import model_share


def read(ctx):
    return model_share(ctx)
