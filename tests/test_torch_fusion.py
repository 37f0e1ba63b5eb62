"""The port's fusion against the JAX package's, on the CPU: ``consistency``,
``consistency_scene`` and ``consistency_tank`` on rendered plane depth maps
with seeded noise: fused depth rtol 1e-5 and the masks equal, but on the
pixels where a ladder comparison lies within fp32 rounding of its
threshold (2e-4 px of reprojection distance, 2e-7 of the depth), at most
5e-4 of them (measured: up to 4e-4 at 96x128, about 2 pixels a view);
``backproject_to_world`` and ``fuse_scene`` (the same points, rtol 1e-5),
and ``write_ply`` byte-equal to JAX's with the ``read_ply`` round trip."""

import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.config import DypcdParams as JaxDypcd
from effi_mvs_plus_tpu.config import TankParams as JaxTank
from effi_mvs_plus_tpu.fuse import dypcd as jax_dypcd
from effi_mvs_plus_tpu.fuse import ply as jax_ply
from effi_mvs_plus_tpu_torch.config import DypcdParams, TankParams
from effi_mvs_plus_tpu_torch.fuse import dypcd, ply
from synth_scene import look_at_extrinsic

H, W, N = 96, 128, 5


def plane_depth(K, E, z):
    """Camera-frame depth of the world plane Z = z seen through (K, E)."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.linalg.inv(K) @ np.stack([xs.ravel(), ys.ravel(),
                                        np.ones(H * W)])
    R, t = E[:3, :3].astype(np.float64), E[:3, 3].astype(np.float64)
    origin, dirs = -R.T @ t, R.T @ rays
    return ((z - origin[2]) / dirs[2]).reshape(H, W)


def make_views(z, baseline, focal, noise, seed=0):
    """N views of the plane Z = z with relative depth noise and seeded
    confidences: (depth (N,H,W), conf (N,H,W), K (N,3,3), E (N,4,4))."""
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    Es = [look_at_extrinsic([baseline * v, baseline / 4 * v, 0.0],
                            [0.0, 0.0, z]) for v in range(N)]
    depth = np.stack([plane_depth(K, E, z) for E in Es])
    depth *= 1 + noise * rng.standard_normal(depth.shape)
    conf = rng.uniform(0, 1, depth.shape)
    return (depth.astype(np.float32), conf.astype(np.float32),
            np.repeat(K[None], N, 0), np.stack(Es).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def near_threshold(args, dist_thr, diff_thr, relative=False):
    """(H,W) bool: pixels of one reference view where a source's
    reprojection distance or depth difference lies within fp32 rounding of
    a ladder threshold.  args: consistency's seven arrays."""
    d_ref = args[0]
    rep, xr, yr = (t.numpy() for t in dypcd._reproject_one(*_t(
        args[0], args[2], args[3], *args[4:])))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dist = np.sqrt((xr - xs) ** 2 + (yr - ys) ** 2)[..., None]
    diff = np.abs(rep - d_ref)[..., None]
    diff_eps = 2e-7 * d_ref[..., None]
    if relative:
        diff, diff_eps = diff / d_ref[..., None], 2e-7
    near = ((np.abs(dist - dist_thr) < 2e-4)
            | (np.abs(diff - diff_thr) < diff_eps))
    return near.any(-1).any(0)


def assert_fusion_close(got, want, near):
    """(final, fused, geo, photo) of the port against JAX's: equal but on
    pixels near a threshold (``near``), few of them."""
    g, w = np.asarray(got[1]), np.asarray(want[1])
    # a pixel whose top-level mask flips averages other sources
    differ = [np.abs(g - w) > 1e-5 * np.abs(w)]
    for g, w in zip(got[::2] + got[3:], want[::2] + want[3:]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype == bool and g.shape == w.shape
        differ.append(g != w)
    assert near.mean() < 0.05                    # the exception is narrow
    for d in differ:
        assert not (d & ~near).any()
        assert d.mean() < 5e-4


def dypcd_thresholds(params):
    levels = np.arange(params.s, params.e, dtype=np.float32)
    return (levels * params.dist_base,
            np.log10(np.maximum(levels, 1.05)) * params.diff_base)


@pytest.fixture(scope="module")
def dtu_views():
    # 0.3 mm of noise at 600 mm: the ladder keeps about 40% of the pixels
    return make_views(600.0, 40.0, 160.0, 3e-4)


def test_consistency_matches_jax(dtu_views):
    depth, conf, K, E = dtu_views
    params = DypcdParams(conf_thresh=0.3)
    args = (depth[0], conf[0], K[0], E[0], depth[1:], K[1:], E[1:])
    got = [x.numpy() for x in dypcd.consistency(*_t(*args), params)]
    want = jax_dypcd.consistency(*args, JaxDypcd(conf_thresh=0.3))
    assert_fusion_close(got, want,
                        near_threshold(args, *dypcd_thresholds(params)))
    assert 0.05 < got[2].mean() < 1.0           # the ladder cuts somewhere


def test_consistency_scene_matches_jax(dtu_views):
    depth, conf, K, E = dtu_views
    ref_ids = np.arange(N, dtype=np.int32)
    src_ids = np.stack([np.roll(np.arange(N), -r)[1:4] for r in range(N)]
                       ).astype(np.int32)
    got = dypcd.consistency_scene(*_t(depth, conf, K, E),
                                  torch.from_numpy(ref_ids).long(),
                                  torch.from_numpy(src_ids).long(),
                                  DypcdParams(), chunk=2)
    want = jax_dypcd.consistency_scene(depth, conf, K, E, ref_ids, src_ids,
                                       JaxDypcd(), chunk=2)
    near = np.stack([near_threshold(
        (depth[r], conf[r], K[r], E[r], depth[s], K[s], E[s]),
        *dypcd_thresholds(DypcdParams())) for r, s in zip(ref_ids, src_ids)])
    assert_fusion_close([x.numpy() for x in got], want, near)


@pytest.mark.parametrize("relative", [False, True])
def test_consistency_tank_matches_jax(relative):
    depth, conf, K, E = make_views(1.6, 0.04, 1.8 * W, 2e-3, seed=1)
    kw = dict(dist_filter=4, depth_filter=200.0, prob_threshold=0.3,
              relative=relative)
    if relative:
        kw["depth_filter"] = 100.0
    args = (depth[0], conf[0], K[0], E[0], depth[1:], K[1:], E[1:])
    got = [x.numpy() for x in dypcd.consistency_tank(*_t(*args),
                                                     TankParams(**kw))]
    want = jax_dypcd.consistency_tank(*args, JaxTank(**kw))
    levels = np.arange(2, N, dtype=np.float32)
    assert_fusion_close(got, want, near_threshold(
        args, levels / kw["dist_filter"], levels / kw["depth_filter"],
        relative))
    assert 0.05 < got[2].mean() < 1.0
    # too few sources for the vote: nothing passes, as in JAX
    few = (depth[0], conf[0], K[0], E[0], depth[1:2], K[1:2], E[1:2])
    got = dypcd.consistency_tank(*_t(*few), TankParams(**kw))
    assert not got[0].any() and torch.equal(got[1], torch.from_numpy(depth[0]))


def test_backproject_and_fuse_scene_match_jax(dtu_views):
    depth, conf, K, E = dtu_views
    mask = conf[0] > 0.5
    got = dypcd.backproject_to_world(depth[0], mask, K[0], E[0])
    want = jax_dypcd.backproject_to_world(depth[0], mask, K[0], E[0])
    np.testing.assert_array_equal(got[0], want[0])

    rng = np.random.default_rng(3)
    views = {v: {"depth": depth[v], "conf": conf[v], "K": K[v], "E": E[v],
                 "image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32)}
             for v in range(N)}
    pairs = [(v, [s for s in range(N) if s != v]) for v in range(N)]
    seen = []
    xyz, rgb = dypcd.fuse_scene(pairs, views.__getitem__, DypcdParams(),
                                progress=lambda *a: seen.append(a[0]),
                                device="cpu")
    want_xyz, want_rgb = jax_dypcd.fuse_scene(pairs, views.__getitem__,
                                              JaxDypcd())
    assert seen == list(range(N))
    assert abs(len(xyz) - len(want_xyz)) <= 1e-4 * N * H * W
    if len(xyz) == len(want_xyz):
        np.testing.assert_allclose(xyz, want_xyz, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(rgb, want_rgb)


def test_fuse_scene_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        dypcd.fuse_scene_device([], {})


def test_ply_bytes_match_jax_and_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.standard_normal((257, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (257, 3)).astype(np.uint8)
    for colours in (rgb, None):
        ply.write_ply(tmp_path / "port.ply", xyz, colours)
        jax_ply.write_ply(str(tmp_path / "jax.ply"), xyz, colours)
        assert (tmp_path / "port.ply").read_bytes() == \
            (tmp_path / "jax.ply").read_bytes()
        got_xyz, got_rgb = ply.read_ply(tmp_path / "port.ply")
        np.testing.assert_array_equal(got_xyz, xyz)
        np.testing.assert_array_equal(
            got_rgb, rgb if colours is not None else np.full_like(rgb, 255))
