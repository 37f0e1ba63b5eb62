"""K3 (the warp's backward, ``csrc/warp_correlate_bwd.cu`` with its d_ref
sum): share (%) of its roofline over a step's launches."""

from portbench.lib import trace as tr


def read(t):
    return tr.roofline_pct(t, "k3_warp_correlate_bwd", "k3")
