"""The numbers that decide ``correct``, each judged against its limit.

Serving: for each sampled answer (a batch row's final depth map and its
photometric confidence) against the reference's on the same inputs, the
mean, median, 75th and 90th percentile of the absolute depth gap, and
the mean and median absolute confidence gap; the worst answer counts.
A cell's ``limits`` name the numbers it is judged by; the others are
readings for ``calibrate.py``.  A missing, misshapen or non-finite
answer reads infinity.

Training: the program's first three steps against the reference's on
the same batches and dropout masks: the first step's loss gap relative
to the reference's, and the largest of the three; the first gradient's
norm, leaf by leaf; and the norm of each leaf's change over the three
steps.  A leaf's gap is the difference of the two norms over the
reference's norm of that leaf or of the median leaf, whichever is
larger; the worst leaf's gap and the median leaf's are numbers.  Leaves whose
reference gradient is under a thousandth of the median leaf's move under
AdamW by round-off alone and are left out of the change.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

INF = math.inf


def _finite(x):
    return x if math.isfinite(x) else INF


def serving_numbers(pairs):
    """pairs: [(depth, conf, ref_depth, ref_conf)] numpy, one per answer
    -> {number: worst value over the answers}."""
    keys = ("depth_mae_mm", "depth_p50_mm", "depth_p75_mm", "depth_p90_mm",
            "conf_mae", "conf_p50")
    out = dict.fromkeys(keys, 0.0)
    if not pairs:
        return dict.fromkeys(keys, INF)
    for d, c, rd, rc in pairs:
        if d is None or d.shape != rd.shape or c.shape != rc.shape:
            return dict.fromkeys(keys, INF)
        err = np.abs(d.astype(np.float64) - rd)
        cerr = np.abs(c.astype(np.float64) - rc)
        if not (np.isfinite(err).all() and np.isfinite(cerr).all()):
            return dict.fromkeys(keys, INF)
        p50, p75, p90 = np.percentile(err, (50, 75, 90))
        vals = {"depth_mae_mm": err.mean(), "depth_p50_mm": p50,
                "depth_p75_mm": p75, "depth_p90_mm": p90, "conf_mae": cerr.mean(), "conf_p50": np.median(cerr)}
        for k, v in vals.items():
            out[k] = max(out[k], float(v))
    return out


def _leaf_gaps(prog, ref, leaves):
    """{leaf: the gap of its norms over max(its reference norm, the
    median leaf's)}."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: _finite(abs(prog.get(k, INF) - ref[k]) / max(ref[k], med))
            for k in leaves}


def training_numbers(prog, ref):
    """prog, ref: {'losses': [3 floats], 'grad': {leaf: norm}, 'change':
    {leaf: norm}} -> ({number: value}, {number: worst leaf})."""
    loss_gap = max(_finite(abs(a - b) / abs(b))
                   for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = INF
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    first = _finite(abs(prog["losses"][0] - ref["losses"][0])
                    / abs(ref["losses"][0]))
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    return ({"loss_gap_first": first, "loss_gap": loss_gap,
             "grad_norm_gap": grad[worst_grad],
             "grad_norm_gap_median": statistics.median(grad.values()),
             "change_norm_gap": change[worst_change],
             "change_norm_gap_median": statistics.median(change.values())},
            {"grad_norm_gap": worst_grad, "change_norm_gap": worst_change,
             "left_out": len(leaves) - len(moving)})


def judge(numbers, limits):
    """(correct, {number: {'value', 'limit'}}): every limited number at or
    under its limit; a number the run did not produce fails."""
    checks = {k: {"value": numbers.get(k, INF), "limit": v}
              for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
