"""The port's eval readers and their bilinear resize against the JAX
package's: ``_resize_bilinear`` against the JAX ``_resize`` (its native
data plane here, cv2 where that is missing) and cv2 itself at down- and
up-scaling ratios (atol 1e-5); ``TanksDataset`` (both cam line-11
variants) and ``GeneralEvalDataset`` against JAX's on trees built by
``tests/synth_scene.py``, arrays equal within 1e-5."""

import os

import cv2
import numpy as np
import pytest

from effi_mvs_plus_tpu.data import datasets as jax_ds
from effi_mvs_plus_tpu_torch.data import datasets as ds
from effi_mvs_plus_tpu_torch.data import find_dataset
from synth_scene import build_scene, build_tank_scene


@pytest.mark.parametrize("src_hw,dst_wh", [
    ((1080, 1920), (960, 528)),      # T&T 1920x1080 -> half of 1920x1056
    ((1080, 1920), (1920, 1056)),    # the T&T reader's own ratio
    ((37, 53), (160, 96)),           # up
    ((64, 96), (48, 32)),            # exactly 2x down
    ((50, 70), (70, 50)),            # down one axis, up the other
])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_bilinear_matches_cv2(src_hw, dst_wh, channels):
    rng = np.random.default_rng(0)
    shape = src_hw + ((channels,) if channels else ())
    img = rng.uniform(0, 1, shape).astype(np.float32)
    got = ds._resize_bilinear(img, dst_wh)
    assert got.dtype == np.float32
    assert got.shape == (dst_wh[1], dst_wh[0]) + shape[2:]
    np.testing.assert_allclose(got, jax_ds._resize(img, dst_wh), atol=1e-5)
    np.testing.assert_allclose(
        got, cv2.resize(img, dst_wh, interpolation=cv2.INTER_LINEAR),
        atol=1e-5)


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["imgs"], want["imgs"], atol=1e-5)
    for k in want["proj_matrices"]:
        np.testing.assert_allclose(got["proj_matrices"][k],
                                   want["proj_matrices"][k], atol=1e-5,
                                   rtol=1e-6)
    np.testing.assert_allclose(got["depth_values"], want["depth_values"],
                               rtol=1e-6)
    assert got["filename"] == want["filename"]


def _rewrite_line11(scene_dir, fields):
    """Replace every cam file's depth line with ``fields``."""
    cams = os.path.join(scene_dir, "cams")
    for name in os.listdir(cams):
        path = os.path.join(cams, name)
        with open(path) as f:
            lines = f.read().splitlines()
        lines[11] = " ".join(str(v) for v in fields)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("fields", [None, [0.4, 3.5]],
                         ids=["4-field", "2-field"])
def test_tanks_dataset_matches_jax(tmp_path, fields):
    scene_dir = build_tank_scene(str(tmp_path), scene="Horse", n_views=4,
                                 H=54, W=96)
    if fields is not None:
        _rewrite_line11(scene_dir, fields)
    kw = dict(nviews=3, ndepths=192, target_wh=(64, 32))
    port = find_dataset("tank")(str(tmp_path), ["Horse"], **kw)
    ref = jax_ds.TanksDataset(str(tmp_path), ["Horse"], **kw)
    assert len(port) == len(ref) == 4
    for i in (0, 3):
        _assert_samples_equal(port[i], ref[i])
    # both line-11 variants give the 1/3.5 .. 1/0.4 inverse-depth sweep
    dv = port[0]["depth_values"]
    assert abs(dv[0] - 1 / 3.5) < 1e-6 and abs(dv[-1] - 1 / 0.4) < 1e-6


def test_general_eval_dataset_matches_jax(tmp_path):
    _, listfile = build_scene(str(tmp_path), n_views=4, H=70, W=100)
    kw = dict(nviews=3, ndepths=192, interval_scale=1.06, max_h=64,
              max_w=96)
    port = find_dataset("general_eval")(str(tmp_path), listfile, **kw)
    ref = jax_ds.GeneralEvalDataset(str(tmp_path), listfile, **kw)
    assert len(port) == len(ref) == 4
    for i in range(4):
        got = port[i]
        assert got["imgs"].shape == (3, 64, 96, 3)
        _assert_samples_equal(got, ref[i])
