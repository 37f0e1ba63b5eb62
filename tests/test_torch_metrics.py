"""The port's legacy depth metrics (``effi_mvs_plus_tpu_torch/train/
metrics.py``) against the JAX package's (``effi_mvs_plus_tpu/train/
metrics.py``) on the CPU: the same seeded maps, zeros in gt and pred
under the mask included, within rtol/atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.train import metrics as jm
from effi_mvs_plus_tpu_torch.train import metrics as tm

TOL = dict(rtol=1e-5, atol=1e-5)


def maps(seed, zeros=True):
    """(gt, pred, mask) (2, 16, 20): depths about 500-900 mm, pred 0.7 to
    1.5 times gt, a random 70% mask; with ``zeros``, some gt and some
    pred are 0 (the reference's infinite ratios and invalid pixels)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(500, 900, (2, 16, 20)).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.5, gt.shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, gt.shape) > 0.3).astype(np.float32)
    if zeros:
        gt[rng.uniform(0, 1, gt.shape) < 0.05] = 0
        pred[rng.uniform(0, 1, gt.shape) < 0.05] = 0
    return gt, pred, mask


@pytest.mark.parametrize("seed,zeros", [(0, True), (1, True), (2, False)])
def test_compute_errors_matches_jax(seed, zeros):
    args = maps(seed, zeros)
    got = tm.compute_errors(*(torch.from_numpy(a) for a in args))
    want = jm.compute_errors(*(jnp.asarray(a) for a in args))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                   err_msg=k)
    assert 0 < float(got["a1"]) < 1


@pytest.mark.parametrize("interval", [2.5, 10.0, 40.0])
def test_interval_metrics_match_jax(interval):
    gt, pred, _ = maps(3)
    t = [torch.from_numpy(a) for a in (gt, pred)]
    j = [jnp.asarray(a) for a in (gt, pred)]
    for name in ("less_one_percentage", "less_three_percentage"):
        got = float(getattr(tm, name)(*t, interval))
        want = float(getattr(jm, name)(*j, interval))
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    got = tm.mvsnet_regression_metrics(*t, interval)
    want = jm.mvsnet_regression_metrics(*j, interval)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], **TOL)
    assert float(got[0]) <= float(got[1])
