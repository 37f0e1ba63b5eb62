"""The port's native data plane (``effi_mvs_plus_tpu_torch/native``, built
here with g++ into build/native): PFM round trips with the port's numpy
codec both ways and a big-endian file, resizes against the port's numpy
INTER_LINEAR and INTER_NEAREST resizes, binary PLY against
``fuse/ply.py``'s numpy writer, which ``write_ply`` (the native route)
matches byte for byte; a failed build raises."""

import numpy as np
import pytest

from effi_mvs_plus_tpu_torch import native
from effi_mvs_plus_tpu_torch.data.datasets import (_resize_bilinear,
                                                   _resize_nearest)
from effi_mvs_plus_tpu_torch.data.pfm import read_pfm, save_pfm
from effi_mvs_plus_tpu_torch.fuse import ply
from effi_mvs_plus_tpu_torch.fuse.ply import read_ply, write_ply_numpy


@pytest.mark.parametrize("shape", [(37, 53), (16, 24, 3)])
def test_pfm_round_trip_with_the_numpy_codec(tmp_path, shape):
    img = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    native.pfm_write(tmp_path / "native.pfm", img)
    out, scale = read_pfm(str(tmp_path / "native.pfm"))
    np.testing.assert_array_equal(out, img)
    save_pfm(str(tmp_path / "numpy.pfm"), img)
    out, scale = native.pfm_read(tmp_path / "numpy.pfm")
    np.testing.assert_array_equal(out, img)
    assert scale == 1.0


def test_pfm_reads_big_endian(tmp_path):
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = tmp_path / "be.pfm"
    with open(p, "wb") as f:
        f.write(b"Pf\n4 3\n1.0\n")            # positive scale: big endian
        np.flipud(img).astype(">f4").tofile(f)
    out, scale = native.pfm_read(p)
    np.testing.assert_array_equal(out, img)
    assert scale == 1.0
    with pytest.raises(OSError, match="PFM"):
        native.pfm_read(tmp_path / "missing.pfm")


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)),
                                     ((51, 77), (64, 96)),
                                     ((108, 192), (105, 192))])
def test_resize_matches_the_numpy_resizes(src, dst, nearest):
    rng = np.random.default_rng(1)
    for ch in (None, 3):
        shape = src if ch is None else (*src, ch)
        img = rng.uniform(0, 1, shape).astype(np.float32)
        got = native.resize(img, (dst[1], dst[0]), nearest=nearest)
        if nearest:
            np.testing.assert_array_equal(
                got, _resize_nearest(img, (dst[1], dst[0])))
        else:
            np.testing.assert_allclose(
                got, _resize_bilinear(img, (dst[1], dst[0])), atol=2e-6)


@pytest.mark.parametrize("colours", [True, False])
def test_ply_matches_fuse_ply(tmp_path, colours):
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(1000, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (1000, 3)).astype(np.uint8) if colours \
        else None
    native.ply_write(tmp_path / "native.ply", xyz, rgb)
    got_xyz, got_rgb = read_ply(str(tmp_path / "native.ply"))
    np.testing.assert_array_equal(got_xyz, xyz)
    if colours:
        write_ply_numpy(str(tmp_path / "numpy.ply"), xyz, rgb)
        assert (tmp_path / "native.ply").read_bytes() == \
            (tmp_path / "numpy.ply").read_bytes()
        np.testing.assert_array_equal(got_rgb, rgb)
    else:
        assert got_rgb is None


@pytest.mark.parametrize("colours", [True, False])
def test_write_ply_takes_the_native_route(tmp_path, monkeypatch, colours):
    """``fuse/ply.write_ply`` writes through ``native.ply_write`` the
    bytes of its numpy writer (white when no colours are given)."""
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(777, 3))
    rgb = rng.integers(0, 256, (777, 3)).astype(np.uint8) if colours \
        else None
    calls = []
    real = native.ply_write
    monkeypatch.setattr(native, "ply_write",
                        lambda *a: calls.append(a) or real(*a))
    ply.write_ply(tmp_path / "native.ply", xyz, rgb)
    assert len(calls) == 1
    write_ply_numpy(tmp_path / "numpy.ply", xyz, rgb)
    assert (tmp_path / "native.ply").read_bytes() == \
        (tmp_path / "numpy.ply").read_bytes()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with its output, no quiet fallback."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
