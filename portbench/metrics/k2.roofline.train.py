"""K2 (ConvGRU step, ``csrc/conv_gru.cu``): share (%) of its roofline over
a step's forward launches."""

from portbench.lib import trace as tr


def read(t):
    return tr.roofline_pct(t, "k2_conv_gru", "k2")
