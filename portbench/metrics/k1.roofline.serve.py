"""K1 (warp + correlation, ``csrc/warp_correlate.cu``): share (%) of its
roofline over a batch's launches."""

from portbench.lib import trace as tr


def read(t):
    return tr.roofline_pct(t, "k1_warp_correlate", "k1")
