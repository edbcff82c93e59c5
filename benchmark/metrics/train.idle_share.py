"""train.idle_share: the share of the traced window in which no operation ran
on the device, while the training step (``train/loop.py``) fed it (from the
device trace: the union of kernels, copies and sets)."""

from benchmark.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx)
