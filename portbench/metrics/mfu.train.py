"""The model's FLOPs a step, forward and backward (counted on the reference
at the cell's shapes), times the steps over the traced window, as a
share (%) of the fp32 peak."""

from portbench.lib import trace as tr


def read(t):
    return tr.mfu_pct(t)
