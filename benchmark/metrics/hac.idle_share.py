"""hac.idle_share: the share of the traced window in which no operation ran
on the device while the call pipeline fed Bonito's HAC CRF model (from the
device trace: the union of kernels, copies and sets)."""

from benchmark.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx)
