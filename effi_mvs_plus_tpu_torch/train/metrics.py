"""Depth-quality metrics of the reference's legacy suite, in torch.

Port of ``effi_mvs_plus_tpu/train/metrics.py``: ``compute_errors``
(monocular-style statistics: abs_rel, rmse, the δ < 1.25^k inlier shares)
and the interval-normalised inlier shares ``less_one_percentage`` /
``less_three_percentage`` / ``mvsnet_regression_metrics``.  Every
function returns 0-d float32 tensors on its inputs' device.
"""

from __future__ import annotations

import torch


def compute_errors(gt, pred, mask):
    """Masked error statistics of (B,H,W) maps: abs_rel, abs_diff, sq_rel
    (the standard deviation of the absolute error over the valid pixels,
    as the reference computes it), rmse, rmse_log (the mean squared log
    difference, as in the reference), a1, a2, a3."""
    gt, pred = gt.float(), pred.float()
    valid = (gt > 0) & (pred > 0)
    m = (mask > 0.5).float() * (pred > 0).float()
    n = torch.sum(m)

    # a zero gt under a valid mask gives an infinite ratio, counted in the
    # denominator and never an inlier, as the reference's division does
    inf = torch.full_like(gt, float("inf"))
    ratio1 = torch.where(m > 0, gt / torch.where(pred == 0, 1.0, pred), 0.0)
    ratio2 = torch.where(m > 0, torch.where(
        gt == 0, inf, pred / torch.where(gt == 0, 1.0, gt)), 0.0)
    thresh = torch.maximum(ratio1, ratio2)
    pos = (thresh > 0).float()
    a1 = torch.sum(pos * (thresh < 1.25)) / n
    a2 = torch.sum(pos * (thresh < 1.25 ** 2)) / n
    a3 = torch.sum(pos * (thresh < 1.25 ** 3)) / n

    abs_d = torch.abs(gt - pred)
    rmse = torch.sqrt(torch.sum(abs_d ** 2 * m) / n)
    rmse_log = torch.sum((torch.log(gt * m + 1e-5)
                          - torch.log(pred + 1e-5)) ** 2 * m) / n
    abs_diff = torch.sum(abs_d * m) / n
    abs_rel = torch.sum(abs_d / (gt + 1e-7) * m) / n
    nv = torch.sum(valid).float()
    mean_v = torch.sum(torch.where(valid, abs_d, 0.0)) / nv.clamp(min=1)
    var_v = (torch.sum(torch.where(valid, (abs_d - mean_v) ** 2, 0.0))
             / (nv - 1).clamp(min=1))
    return {"abs_rel": abs_rel, "abs_diff": abs_diff,
            "sq_rel": torch.sqrt(var_v), "rmse": rmse, "rmse_log": rmse_log,
            "a1": a1, "a2": a2, "a3": a3}


def _less_k_percentage(y_true, y_pred, interval, k):
    m = ((y_true > 0) & (y_pred > 0)).float()
    inlier = m * (torch.abs(y_true - y_pred) / interval < k)
    return torch.sum(inlier) / (torch.sum(m) + 1e-7)


def less_one_percentage(y_true, y_pred, interval):
    """The share of valid pixels within one depth interval."""
    return _less_k_percentage(y_true, y_pred, interval, 1.0)


def less_three_percentage(y_true, y_pred, interval):
    """The share of valid pixels within three depth intervals."""
    return _less_k_percentage(y_true, y_pred, interval, 3.0)


def mvsnet_regression_metrics(depth_gt, depth_est, depth_interval):
    """(less-one, less-three) accuracy pair."""
    return (less_one_percentage(depth_gt, depth_est, depth_interval),
            less_three_percentage(depth_gt, depth_est, depth_interval))
