"""Serving in a closed loop, as ``serve_closed``, for a configuration that
computes in fp32 with TF32 off: the same session, window, end-to-end
metrics and check.  Only the limits' readings differ: the control is the
reference computed in TF32, the precision just below true fp32
(``serve_closed``'s fp8 control lies several steps further down).

Parameters: as ``serve_closed``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import compare, controls
from portbench.reference import model as ref_model
from portbench.reference import weights as ref_weights
from portbench.traffic.serve_closed import (Session, _conf_one_bin_late,
                                            _device_batch,
                                            reference_answers)

__all__ = ["Session", "calibrate", "tf32_answers"]


def tf32_answers(params, model_cfg, batch, device):
    """The control: ``reference_answers`` with TF32 on for the reference's
    convolutions and matrix products."""
    out = []
    for b in range(batch["imgs"].shape[0]):
        with torch.no_grad(), controls.precision(tf32=True):
            preds, conf = ref_model.Reference(params, model_cfg).forward(
                **_device_batch(batch, slice(b, b + 1), device))
        out.append((preds[-1][0].double().cpu().numpy(),
                    conf[0].double().cpu().numpy()))
    return out


def calibrate(ctx, shared):
    """One seed's readings for the limits: the program's timed path over
    the pool against the reference, the TF32 control's, and the three
    planted faults of the confidence alone that ``serve_closed`` plants
    (zeros, the next batch row's, read one bin late; the reference's depth
    kept).  ``shared`` keeps the engine from one seed to the next."""
    dtype = ctx.config["model"]["compute_dtype"]
    if dtype != "float32":
        raise ValueError(f"serve_closed_fp32 needs an fp32 configuration, "
                         f"not {dtype}")
    sess = Session(ctx, shared.get("engine"))
    shared["engine"] = sess.engine
    for _ in range(max(sess.sample, len(sess.pool))):
        sess.step()
    program = sess.check()
    model_cfg = ctx.config["model"]
    params = ref_weights.to_device(ref_weights.load_npz(
        ctx.root / ctx.config["checkpoint"]), ctx.device)
    pairs, faults = [], {"conf_zero": [], "conf_next_row": [],
                         "conf_bin_late": []}
    for i, batch in enumerate(sess.pool):
        ref = sess.refs.get(i) or reference_answers(params, model_cfg, batch,
                                                    ctx.device)
        ctl = tf32_answers(params, model_cfg, batch, ctx.device)
        pairs += [(c[0], c[1], *r) for c, r in zip(ctl, ref)]
        true_conf = ref_model.photometric_confidence
        ref_model.photometric_confidence = _conf_one_bin_late
        try:
            late = reference_answers(params, model_cfg, batch, ctx.device)
        finally:
            ref_model.photometric_confidence = true_conf
        for b, (d, c) in enumerate(ref):
            faults["conf_zero"].append((d, np.zeros_like(c), d, c))
            faults["conf_next_row"].append(
                (d, ref[(b + 1) % len(ref)][1], d, c))
            faults["conf_bin_late"].append((d, late[b][1], d, c))
    return {"program": program, "control": compare.serving_numbers(pairs),
            "faults": {k: compare.serving_numbers(v)
                       for k, v in faults.items()}}
