"""The port's static fusion (``effi_mvs_plus_tpu_torch/fuse/static.py``)
against the JAX package's (``effi_mvs_plus_tpu/fuse/static.py``) on the
CPU: the same seeded scenes through both, coordinates and depths within
rtol/atol 1e-5, masks equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.fuse import static as jstatic
from effi_mvs_plus_tpu_torch.fuse import static as tstatic

TOL = dict(rtol=1e-5, atol=1e-5)


def make_scene(S=3, H=24, W=32, seed=3):
    """A slanted reference depth and S noisy source depths seen from
    cameras yawed by 0.05 rad a view and shifted, so that reprojections
    exercise every term and some leave the image (the clamp)."""
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    E_ref = np.eye(4, dtype=np.float32)
    E_srcs = []
    for v in range(1, S + 1):
        a = 0.05 * v
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        E[:3, 3] = [0.3 * v, 0.05 * v, 0.02 * v]
        E_srcs.append(E)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth_ref = 5.0 + 0.01 * xx + 0.005 * yy
    depth_srcs = np.stack([
        5.0 + 0.01 * xx - 0.004 * yy
        + 0.02 * rng.standard_normal((H, W)).astype(np.float32)
        for _ in range(S)])
    conf = rng.uniform(0.5, 1.0, (H, W)).astype(np.float32)
    return (depth_ref, conf, K, E_ref, depth_srcs,
            np.broadcast_to(K, (S, 3, 3)).copy(), np.stack(E_srcs))


def _both(fn_name, *args, **kw):
    got = getattr(tstatic, fn_name)(*(torch.from_numpy(a) for a in args),
                                    **kw)
    want = getattr(jstatic, fn_name)(*(jnp.asarray(a) for a in args), **kw)
    return got, want


@pytest.mark.parametrize("S", [1, 3])
def test_get_reproj_matches_jax(S):
    depth_ref, _, K, E_ref, depth_srcs, K_srcs, E_srcs = make_scene(S)
    (xyd, inr), (xyd_j, inr_j) = _both("get_reproj", depth_ref, K, E_ref,
                                       depth_srcs, K_srcs, E_srcs)
    np.testing.assert_allclose(xyd.numpy(), np.asarray(xyd_j), **TOL)
    np.testing.assert_array_equal(inr.numpy(), np.asarray(inr_j))
    assert 0 < inr.float().mean() < 1     # some reprojections leave


@pytest.mark.parametrize("img_dist,depth_thr,vthresh", [
    (1.0, 10.0, 2.0), (2.0, 100.0, 3.0), (0.5, 4.0, 1.0)])
def test_vis_filter_and_ave_fusion_match_jax(img_dist, depth_thr, vthresh):
    depth_ref, _, K, E_ref, depth_srcs, K_srcs, E_srcs = make_scene()
    xyd = jstatic.get_reproj(*(jnp.asarray(a) for a in (
        depth_ref, K, E_ref, depth_srcs, K_srcs, E_srcs)))[0]
    xyd = np.array(xyd)
    masks, vote = tstatic.vis_filter(torch.from_numpy(depth_ref),
                                     torch.from_numpy(xyd), img_dist,
                                     depth_thr, vthresh)
    masks_j, vote_j = jstatic.vis_filter(jnp.asarray(depth_ref),
                                         jnp.asarray(xyd), img_dist,
                                         depth_thr, vthresh)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(masks_j))
    np.testing.assert_array_equal(vote.numpy(), np.asarray(vote_j))
    assert 0 < masks.float().mean() < 1
    fused = tstatic.ave_fusion(torch.from_numpy(depth_ref),
                               torch.from_numpy(xyd), masks)
    fused_j = jstatic.ave_fusion(jnp.asarray(depth_ref), jnp.asarray(xyd),
                                 masks_j)
    np.testing.assert_allclose(fused.numpy(), np.asarray(fused_j), **TOL)


@pytest.mark.parametrize("greater", [True, False])
def test_prob_filter_matches_jax(greater):
    conf = np.random.default_rng(5).uniform(0, 1, (3, 8, 9)).astype(
        np.float32)
    thr = [0.3, 0.2, 0.5] if greater else [0.9, 0.7, 0.8]
    got = tstatic.prob_filter(torch.from_numpy(conf), thr, greater)
    want = jstatic.prob_filter(jnp.asarray(conf), thr, greater)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.float().mean() < 1


@pytest.mark.parametrize("kw", [{}, {"prob_thresh": 0.7,
                                     "img_dist_thresh": 2.0,
                                     "depth_thresh": 10.0, "vthresh": 3.0}])
def test_consistency_static_matches_jax(kw):
    scene = make_scene()
    got, want = _both("consistency_static", *scene, **kw)
    for name, g, w in zip(("final", "fused", "geo", "photo"), got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)
    assert 0 < got[0].float().mean() < 1
