"""The port's inference CLIs end to end on the CPU, with the JAX tests'
oracles at their rigs: ``cli/test_tank.main --device cpu`` (reader ->
engine -> PFM -> dynamic fusion -> PLY) on the CI rig of
``tests/test_e2e_tank_accuracy.py`` must score overall < SPACING/2
(29.8 mm) against the known plane, and ``cli/test_dtu.main --device cpu``
on ``tests/synth_scene.build_scene``'s rig under 2 mm
(``tests/test_e2e_accuracy.py``'s bound), each scored by the port's
``eval/dtu.py``.  The JAX versions of these chains stay ``slow``."""

import os

import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu_torch.cli import eval_dtu, test_dtu, test_tank
from effi_mvs_plus_tpu_torch.eval import dtu as E
from effi_mvs_plus_tpu_torch.fuse.ply import read_ply
from synth_scene import build_scene, build_tank_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "model_{}.npz")

# tests/test_e2e_tank_accuracy.py's rig and bound
PLANE_Z_M, BAND_M, FOCAL_MULT = 1.6, (0.4, 3.5), 1.8
SPACING_MM = PLANE_Z_M ** 2 * (1 / BAND_M[0] - 1 / BAND_M[1]) / 95 * 1000.0


def plane_gt(half_x, half_y, z, inset, spacing, margin, res):
    """The plane z sampled over the reference view's inset footprint, a
    permissive voxel mask and a ground plane below it."""
    xs = np.arange(-half_x + inset, half_x - inset, spacing)
    ys = np.arange(-half_y + inset, half_y - inset, spacing)
    gx, gy = np.meshgrid(xs, ys)
    stl = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], 1)
    bb = np.array([[xs[0] - margin, ys[0] - margin, z - 2 * margin],
                   [xs[-1] + margin, ys[-1] + margin, z + 2 * margin]])
    obs = np.ones(tuple(np.ceil((bb[1] - bb[0]) / res).astype(int) + 2),
                  bool)
    return stl, obs, bb


def test_tank_cli_reaches_the_plane(tmp_path):
    H, W, scene = 128, 192, "Horse"
    root, out = str(tmp_path / "tt"), str(tmp_path / "out")
    build_tank_scene(root, scene=scene, n_views=6, H=H, W=W,
                     plane_z=PLANE_Z_M, depth_min=BAND_M[0],
                     depth_max=BAND_M[1], focal_mult=FOCAL_MULT)
    test_tank.main(["--device", "cpu", "--testpath", root,
                    "--loadckpt", CKPT.format("tank"), "--outdir", out,
                    "--scenes", scene, "--num_view", "5",
                    "--max_h", str(H), "--max_w", str(W),
                    "--depth_filter", "200"])
    method = np.asarray(read_ply(os.path.join(out, f"{scene}.ply"))[0],
                        np.float64) * 1000.0
    assert len(method) > 500

    plane_mm, f = PLANE_Z_M * 1000.0, FOCAL_MULT * W
    stl, obs, bb = plane_gt((W / 2 - 1) / f * plane_mm,
                            (H / 2 - 1) / f * plane_mm, plane_mm, 30.0,
                            5.0, 100.0, 10.0)
    r = E.evaluate_scan(method, stl, obs, bb, 10.0,
                        np.array([0.0, 0.0, 1.0, -(plane_mm - 150.0)]),
                        dst=2.0, max_dist=100.0)
    overall = (r.acc_mean + r.comp_mean) / 2
    assert overall < SPACING_MM / 2, (overall, r)
    assert r.acc_mean < SPACING_MM / 2 and r.comp_mean < SPACING_MM / 2


def test_dtu_cli_reaches_the_plane(tmp_path):
    # tests/test_e2e_accuracy.py's rig: plane at 600 mm, focal 960 px,
    # 80 mm baseline
    H, W, views, plane, focal = 128, 160, 5, 600.0, 960.0
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    _, listfile = build_scene(root, n_views=views, H=H, W=W,
                              depth_plane=plane, focal=focal, baseline=80.0)
    test_dtu.main(["--device", "cpu", "--testpath", root,
                   "--testlist", listfile, "--loadckpt", CKPT.format("dtu"),
                   "--outdir", out, "--num_view", str(views),
                   "--max_h", str(H), "--max_w", str(W), "--conf", "0.3"])
    method = np.asarray(read_ply(os.path.join(out, "mvsnet001_l3.ply"))[0],
                        np.float64)
    assert len(method) > 1000

    x0, x1 = -W / 2 / focal * plane, (W / 2 - 1) / focal * plane
    y0, y1 = -H / 2 / focal * plane, (H / 2 - 1) / focal * plane
    stl, obs, bb = plane_gt((x1 - x0) / 2, (y1 - y0) / 2, plane, 5.0, 0.8,
                            20.0, 4.0)
    stl[:, 0] += (x0 + x1) / 2
    stl[:, 1] += (y0 + y1) / 2
    bb[:, :2] += [(x0 + x1) / 2, (y0 + y1) / 2]
    r = E.evaluate_scan(method, stl, obs, bb, 4.0,
                        np.array([0.0, 0.0, 1.0, -(plane - 30.0)]), dst=0.2)
    overall = (r.acc_mean + r.comp_mean) / 2
    assert overall < 2.0 and r.acc_mean < 2.0 and r.comp_mean < 2.0, r


@pytest.mark.parametrize("flags,want", [
    ([], "cuda"), (["--device", "cpu", "--num_worker", "1"], "cpu")])
def test_dtu_cli_fuses_on_the_requested_device(tmp_path, monkeypatch, flags,
                                              want):
    """Every scan's fusion runs on --device, ``cuda`` unless told
    otherwise (fuse_scene stubbed: only the device it is given is read;
    on the CPU in this process, ``--num_worker 1``: a pool's spawned
    processes do not see the stub)."""
    import effi_mvs_plus_tpu_torch.data as data
    import effi_mvs_plus_tpu_torch.fuse as fuse
    seen = []

    def fuse_scene(pair, load_view, params, progress=None, mask_dir=None,
                   device=None):
        seen.append(device)
        return np.zeros((0, 3), np.float32), None
    monkeypatch.setattr(data, "read_pair_file", lambda path: [])
    monkeypatch.setattr(fuse, "fuse_scene", fuse_scene)
    monkeypatch.setattr(fuse, "write_ply", lambda *a: None)
    listfile = tmp_path / "list.txt"
    listfile.write_text("scan1\nscan4\n")
    test_dtu.main(["--testpath", str(tmp_path), "--testlist", str(listfile),
                   "--loadckpt", "x.npz", "--outdir", str(tmp_path),
                   "--skip_depth", *flags])
    assert seen == [want, want]


def test_dtu_cli_fusion_pool_writes_the_serial_bytes(tmp_path):
    """``--device cpu --num_worker 2`` fuses two scans in a spawn pool of
    two processes and writes the PLY bytes that ``--num_worker 1`` (scan
    after scan in this process) writes."""
    import shutil
    H, W, views = 64, 80, 3
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    build_scene(root, n_views=views, H=H, W=W, baseline=40.0)
    common = ["--device", "cpu", "--testpath", root, "--loadckpt",
              CKPT.format("dtu"), "--outdir", out, "--num_view", str(views),
              "--max_h", str(H), "--max_w", str(W), "--conf", "0.3"]
    one = tmp_path / "one.txt"
    one.write_text("scan1\n")
    test_dtu.main(common + ["--testlist", str(one), "--skip_fusion"])
    shutil.copytree(os.path.join(root, "scan1"), os.path.join(root, "scan4"))
    shutil.copytree(os.path.join(out, "scan1"), os.path.join(out, "scan4"))
    both = tmp_path / "both.txt"
    both.write_text("scan1\nscan4\n")
    written = {}
    for workers in ("1", "2"):
        test_dtu.main(common + ["--testlist", str(both), "--skip_depth",
                                "--num_worker", workers])
        paths = [os.path.join(out, f"mvsnet00{i}_l3.ply") for i in (1, 4)]
        assert len(read_ply(paths[0])[0]) > 0
        written[workers] = [open(p, "rb").read() for p in paths]
        for p in paths:
            os.remove(p)
    assert written["2"] == written["1"]


def test_inference_clis_refuse_what_is_not_ported(tmp_path):
    """Nothing of either CLI is refused any more: ``--shard_views`` is
    taken, and a single process runs the engine unsharded; without a GPU
    the default device raises."""
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    args = test_tank.build_parser().parse_args(
        ["--testpath", str(tmp_path), "--loadckpt", "x.npz",
         "--shard_views"])
    assert args.shard_views
    eng = InferenceEngine(load_npz_checkpoint(CKPT.format("tank")),
                          device="cpu", shard_policy="views")
    assert eng._policy is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            test_tank.main(["--testpath", str(tmp_path), "--loadckpt",
                            CKPT.format("tank"), "--skip_fusion"])
    assert eval_dtu.build_parser().parse_args(
        ["--plydir", "p", "--gtpath", "g", "--testlist", "l"]).dst == 0.2
