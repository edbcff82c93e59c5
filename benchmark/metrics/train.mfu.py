"""train.mfu: the training step's share of the card's peak: three times the
frozen forward FLOP count a window (the forward, and the backward's two
products a weight), times the rows stepped in the traced window, over the
window, against the float32 cell's peak (495 TFLOP/s, the fastest
float32-operand rate)."""

from benchmark.metrics._common import model_share


def read(ctx):
    return model_share(ctx, passes=3.0)
