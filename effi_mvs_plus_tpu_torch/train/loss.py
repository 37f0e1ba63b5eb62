"""Multi-stage supervised loss and depth metrics.

The port of ``effi_mvs_plus_tpu/train/loss.py``.  The 13 predictions
[init, s1 x3 iters, s1 up, s2 x3, s2 up, s3 x3, s3 up] are supervised
against the GT pyramid stages [1,1,1,1,2,2,2,2,3,3,3,3,4]
(``PRED_STAGE_MAP``).  Per-prediction loss is the mean smooth-L1 over the
valid (mask > 0.5) pixels; weights are 1.0 for the first prediction and
``loss_rate**(L-i-1)`` for the others.  Masked means are where-sums, as
in the JAX package.
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.parallel import mesh as par

PRED_STAGE_MAP = (1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4)


def smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_mean(values, mask):
    """Mean of values over the mask; under a data-parallel policy over
    the global batch (sum and count all-reduced over the data group)."""
    w = mask.to(values.dtype)
    num, den = par.reduce_data(torch.stack([(values * w).sum(), w.sum()]))
    return num / den.clamp_min(1.0)


def mvs_loss(depth_preds, depth_gt_stages, mask_stages, loss_rate=1.0,
             stage_map=PRED_STAGE_MAP):
    """depth_preds: list of (B,h,w); depth_gt_stages/mask_stages:
    {'stage1'..'stage4': (B,h,w)}.  Returns (total, per-pred dict)."""
    total = 0.0
    per = {}
    L = len(depth_preds)
    for i, pred in enumerate(depth_preds):
        gt = depth_gt_stages[f"stage{stage_map[i]}"]
        mask = mask_stages[f"stage{stage_map[i]}"] > 0.5
        li = masked_mean(smooth_l1(pred, gt), mask)
        per[f"l{i}"] = li
        weight = 1.0 if i == 0 else loss_rate ** (L - i - 1)
        total = total + weight * li
    return total, per


def _per_image_mean(values, sel):
    """Mean over the selected pixels of each image, then over the batch."""
    dims = tuple(range(1, values.dim()))
    w = sel.to(values.dtype)
    per_img = (values * w).sum(dims) / w.sum(dims).clamp_min(1.0)
    return per_img.mean()


def abs_depth_error(pred, gt, mask, band=None):
    """Mean |err| over masked pixels, per image then batch-meaned; with
    ``band=(lo, hi)`` restricted to errors in [lo, hi] (0 when the band
    selects nothing)."""
    err = (pred - gt).abs()
    sel = mask > 0.5
    if band is not None:
        sel = sel & (err >= band[0]) & (err <= band[1])
    return _per_image_mean(err, sel)


def threshold_error(pred, gt, mask, thresh):
    """Fraction of valid pixels with |err| > thresh, per image then
    batch-meaned."""
    err = (pred - gt).abs()
    return _per_image_mean((err > thresh).float(), mask > 0.5)
