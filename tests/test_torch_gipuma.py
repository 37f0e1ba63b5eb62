"""The port's Gipuma/fusibile export (``effi_mvs_plus_tpu_torch/fuse/
gipuma.py``) against the JAX package's (``effi_mvs_plus_tpu/fuse/
gipuma.py``): the .dmb codec, the P-matrix camera file, the scene layout
with a confidence at half the depth's size (resized by the port's numpy
INTER_LINEAR rules, where the JAX package calls cv2) and fusibile's
command line, run on a stub executable."""

import os
import stat
import sys

import numpy as np
import pytest

from effi_mvs_plus_tpu.fuse import gipuma as jg
from effi_mvs_plus_tpu_torch.data import cams as camio
from effi_mvs_plus_tpu_torch.data.datasets import _resize_bilinear
from effi_mvs_plus_tpu_torch.data.pfm import read_pfm, save_pfm
from effi_mvs_plus_tpu_torch.fuse import gipuma as tg

K = np.array([[100., 0, 16], [0, 100., 12], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("shape", [(24, 32), (24, 32, 3)])
def test_dmb_round_trip_matches_jax(tmp_path, shape):
    arr = np.random.default_rng(0).uniform(400, 900, shape).astype(
        np.float32)
    tg.write_dmb(str(tmp_path / "port.dmb"), arr)
    jg.write_dmb(str(tmp_path / "jax.dmb"), arr)
    assert (tmp_path / "port.dmb").read_bytes() == \
        (tmp_path / "jax.dmb").read_bytes()
    np.testing.assert_array_equal(tg.read_dmb(str(tmp_path / "jax.dmb")),
                                  arr)
    np.testing.assert_array_equal(tg.fake_normal(arr[..., 0] if arr.ndim == 3
                                                 else arr),
                                  jg.fake_normal(arr[..., 0] if arr.ndim == 3
                                                 else arr))


def test_gipuma_cam_matches_jax(tmp_path):
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [1, 2, 3]
    tg.write_gipuma_cam(str(tmp_path / "port.P"), E, K)
    jg.write_gipuma_cam(str(tmp_path / "jax.P"), E, K)
    assert (tmp_path / "port.P").read_text() == \
        (tmp_path / "jax.P").read_text()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port.P"),
                               K @ E[:3, :4], rtol=1e-6)


def _scene(root, half_conf):
    """A saved scene of two views (depth_est, confidence at the depth's
    size or half of it, cams, one image)."""
    rng = np.random.default_rng(1)
    for sub in ("cams", "depth_est", "confidence", "images"):
        os.makedirs(os.path.join(root, sub))
    for vid in (0, 1):
        E = np.eye(4, dtype=np.float32)
        E[:3, 3] = [vid, 0, 0]
        camio.write_cam_file(os.path.join(root, "cams",
                                          f"{vid:08d}_cam.txt"),
                             E, K, [425.0, 2.5])
        depth = rng.uniform(400, 900, (24, 32)).astype(np.float32)
        ch, cw = (12, 16) if half_conf else (24, 32)
        conf = rng.uniform(0, 1, (ch, cw)).astype(np.float32)
        save_pfm(os.path.join(root, "depth_est", f"{vid:08d}.pfm"), depth)
        save_pfm(os.path.join(root, "confidence", f"{vid:08d}.pfm"), conf)
    with open(os.path.join(root, "images", "00000000.jpg"), "wb") as f:
        f.write(b"not decoded, only copied")


@pytest.mark.parametrize("half_conf", [False, True])
def test_convert_scene_layout(tmp_path, half_conf):
    out = str(tmp_path / "scan1")
    _scene(out, half_conf)
    gdir = str(tmp_path / "gipuma")
    tg.convert_scene(out, gdir, [0, 1], prob_threshold=0.5)
    assert os.path.exists(os.path.join(gdir, "images", "00000000.jpg"))
    for vid in (0, 1):
        name = f"{vid:08d}"
        depth = read_pfm(os.path.join(out, "depth_est", f"{name}.pfm"))[0]
        conf = read_pfm(os.path.join(out, "confidence", f"{name}.pfm"))[0]
        if half_conf:
            conf = _resize_bilinear(conf, (32, 24))
        disp = tg.read_dmb(os.path.join(gdir, f"2333_{name}", "disp.dmb"))
        np.testing.assert_array_equal(disp, np.where(conf >= 0.5, depth, 0))
        assert (disp == 0).any() and (disp > 0).any()
        normals = tg.read_dmb(os.path.join(gdir, f"2333_{name}",
                                           "normals.dmb"))
        np.testing.assert_array_equal(normals, jg.fake_normal(depth))
        cam = os.path.join(gdir, "cams", f"{name}.jpg.P")
        E = np.eye(4, dtype=np.float32)
        E[:3, 3] = [vid, 0, 0]
        np.testing.assert_allclose(np.loadtxt(cam), K @ E[:3, :4],
                                   rtol=1e-6)
    if not half_conf:   # the JAX converter needs cv2 only to resize
        jdir = str(tmp_path / "gipuma_jax")
        jg.convert_scene(out, jdir, [0, 1], prob_threshold=0.5)
        for rel in ("2333_00000000/disp.dmb", "2333_00000001/normals.dmb",
                    "cams/00000001.jpg.P"):
            with open(os.path.join(gdir, rel), "rb") as a, \
                    open(os.path.join(jdir, rel), "rb") as b:
                assert a.read() == b.read(), rel


def test_run_fusibile_command_line(tmp_path):
    """The port's command line is the JAX package's, word for word, as a
    stub executable receives it."""
    stub = tmp_path / "fusibile"
    stub.write_text(f"#!{sys.executable}\nimport sys\n"
                    "print('\\n'.join(sys.argv[1:]))\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    gdir = str(tmp_path / "g")
    got = tg.run_fusibile(str(stub), gdir, disp_threshold=0.3,
                          num_consistent=4)
    want = jg.run_fusibile(str(stub), gdir, disp_threshold=0.3,
                           num_consistent=4)
    assert got.returncode == 0 and got.stdout == want.stdout
    assert got.stdout.split("\n")[:2] == ["-input_folder", gdir + "/"]
    assert "--disp_thresh=0.3" in got.stdout
    assert "--num_consistent=4" in got.stdout
