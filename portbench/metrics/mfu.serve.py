"""The model's FLOPs a batch (counted on the reference at the cell's
shapes) times the batches over the traced window, as a share (%) of the
compute dtype's dense peak."""

from portbench.lib import trace as tr


def read(t):
    return tr.mfu_pct(t)
