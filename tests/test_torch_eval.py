"""The port's DTU chamfer evaluation against the JAX package's on seeded
clouds: ``reduce_pts`` keeps the same points, ``evaluate_scan`` gives the
same statistics (rtol 1e-6) and artifacts, ``aggregate`` the same
overall, and ``cli/eval_dtu.py`` the same result as the JAX CLI on the
official file layout."""

import numpy as np
import pytest

from effi_mvs_plus_tpu.eval import dtu as jax_dtu
from effi_mvs_plus_tpu_torch.eval import dtu


def _scene(seed):
    """A noisy sampled patch (the method cloud), its structured-light
    ground truth and a voxel mask that covers part of it."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 40, (4000, 2))
    method = np.c_[xy, 0.3 * rng.standard_normal(4000)]
    gx, gy = np.meshgrid(np.arange(0, 40, 0.5), np.arange(0, 40, 0.5))
    stl = np.c_[gx.ravel(), gy.ravel(), np.zeros(gx.size)]
    bb = np.array([[-5.0, -5.0, -5.0], [45.0, 45.0, 5.0]])
    res = 2.0
    obs = rng.uniform(0, 1, (27, 27, 7)) < 0.8
    plane = np.array([0.0, 0.1, 1.0, 0.5])
    return method, stl, obs, bb, res, plane


@pytest.mark.parametrize("dst", [0.2, 0.7])
def test_reduce_pts_matches_jax(dst):
    method = _scene(0)[0]
    got = dtu.reduce_pts(method, dst, seed=3)
    np.testing.assert_array_equal(got, jax_dtu.reduce_pts(method, dst,
                                                           seed=3))
    assert 0 < got.sum() < len(method)


@pytest.mark.parametrize("seed", [1, 2])
def test_evaluate_scan_matches_jax(seed):
    args = _scene(seed)
    kw = dict(dst=0.4, max_dist=1.0, return_artifacts=True)
    got = dtu.evaluate_scan(*args, **kw)
    want = jax_dtu.evaluate_scan(*args, **kw)
    for f in ("acc_mean", "comp_mean", "acc_median", "comp_median"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6)
    assert (got.n_data, got.n_stl) == (want.n_data, want.n_stl)
    for f in ("q_data", "d_data", "data_in_mask", "q_stl", "d_stl",
              "stl_above_plane"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    results = [got, dtu.evaluate_scan(*_scene(seed + 10), dst=0.4)]
    want_all = [want, jax_dtu.evaluate_scan(*_scene(seed + 10), dst=0.4)]
    agg, want_agg = dtu.aggregate(results), jax_dtu.aggregate(want_all)
    for k, v in want_agg.items():
        np.testing.assert_allclose(agg[k], v, rtol=1e-6)


def test_eval_dtu_cli_matches_jax(tmp_path):
    """cli/eval_dtu.py on a scan in the official layout (method PLY, STL
    PLY, ObsMask and Plane .mat files) against the JAX CLI."""
    import scipy.io

    from effi_mvs_plus_tpu.cli import eval_dtu as jax_cli
    from effi_mvs_plus_tpu_torch.cli import eval_dtu
    from effi_mvs_plus_tpu_torch.fuse.ply import write_ply

    method, stl, obs, bb, res, plane = _scene(4)
    plydir, gt = tmp_path / "ply", tmp_path / "gt"
    for d in (plydir, gt / "Points" / "stl", gt / "ObsMask"):
        d.mkdir(parents=True)
    write_ply(plydir / "mvsnet001_l3.ply", method)
    write_ply(gt / "Points" / "stl" / "stl001_total.ply", stl)
    scipy.io.savemat(gt / "ObsMask" / "ObsMask1_10.mat",
                     {"ObsMask": obs, "BB": bb, "Res": res})
    scipy.io.savemat(gt / "ObsMask" / "Plane1.mat", {"P": plane})
    (tmp_path / "list.txt").write_text("scan1\n")
    argv = ["--plydir", str(plydir), "--gtpath", str(gt), "--testlist",
            str(tmp_path / "list.txt"), "--num_worker", "1", "--dst", "0.4",
            "--max_dist", "1.0"]
    got = eval_dtu.main(argv + ["--out", str(tmp_path / "port.json")])
    want = jax_cli.main(argv)
    for k in ("mean_acc_mm", "mean_comp_mm", "overall_mm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert (tmp_path / "port.json").exists()
