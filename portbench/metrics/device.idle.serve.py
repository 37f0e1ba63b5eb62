"""Share (%) of the traced window in which no kernel and no copy runs on
the card."""


def read(t):
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
