"""K4 (the FPN's stem chain, ``csrc/conv_chain.cu``): share (%) of its
roofline over a batch's launches."""

from portbench.lib import trace as tr


def read(t):
    return tr.roofline_pct(t, "k4_conv_chain", "k4")
