"""The port's legacy 3-D-distance fusion tail
(``effi_mvs_plus_tpu_torch/fuse/legacy.py``) against the JAX package's
(``effi_mvs_plus_tpu/fuse/legacy.py``) on the CPU, the half-pixel skew of
``homo_warping`` included: the same seeded scenes through both, within
rtol/atol 1e-5.

``filter_depth``'s clouds and distances are held within 1e-5 of the
cloud's scale (max |point|, about 59 here) instead of elementwise: the
sources' clouds are sampled where the noisy depths make them steep, and
there fp32 rounding of the sampling coordinates moves a point by a few
1e-6 of the scale whatever the code.  The JAX function's own vmap moves
the third view's points 2.1e-4 from its unbatched calls (3.6e-6 of the
scale), and both lie 2.8e-4 from a float64 evaluation; the port matches
the unbatched calls within 3e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.fuse import legacy as jlegacy
from effi_mvs_plus_tpu_torch.fuse import legacy as tlegacy

TOL = dict(rtol=1e-5, atol=1e-5)


def make_scene(H=24, W=32, V=3, seed=7):
    """A noisy reference depth around 50-60 and V source depths near it,
    seen from cameras yawed by 0.04 rad a view and shifted; projections
    as (2,4,4) [extrinsics, intrinsics] stacks."""
    rng = np.random.default_rng(seed)
    f = 1.2 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

    def stacked(v):
        a = 0.04 * v
        out = np.zeros((2, 4, 4), np.float32)
        out[0] = np.eye(4)
        out[0, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        out[0, :3, 3] = [2.0 * v, 0.5 * v, 0.3 * v]
        out[1] = np.eye(4)
        out[1, :3, :3] = K
        return out
    base = 50.0 + 10.0 * rng.random((H, W)).astype(np.float32)
    src_depths = np.stack([base + rng.normal(0, 0.3, (H, W)).astype(
        np.float32) for _ in range(V)])
    return base, src_depths, stacked(0), np.stack([stacked(v + 1)
                                                   for v in range(V)])


@pytest.mark.parametrize("shape", [(2, 4, 4), (3, 2, 4, 4), (4, 4)])
def test_compose_proj_matches_jax(shape):
    proj = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(
        tlegacy.compose_proj(torch.from_numpy(proj)).numpy(),
        np.asarray(jlegacy.compose_proj(jnp.asarray(proj))), **TOL)


@pytest.mark.parametrize("composed", [False, True])
def test_generate_points_matches_jax(composed):
    ref_depth, _, ref_proj, _ = make_scene()
    if composed:
        ref_proj = np.array(jlegacy.compose_proj(ref_proj))
    got = tlegacy.generate_points_from_depth(torch.from_numpy(ref_depth),
                                             torch.from_numpy(ref_proj))
    want = jlegacy.generate_points_from_depth(jnp.asarray(ref_depth),
                                              jnp.asarray(ref_proj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_homo_warping_matches_jax():
    ref_depth, _, ref_proj, src_projs = make_scene()
    H, W = ref_depth.shape
    fea = np.random.default_rng(0).random((H, W, 3)).astype(np.float32)
    src_P = np.array(jlegacy.compose_proj(src_projs[0]))
    ref_P = np.array(jlegacy.compose_proj(ref_proj))
    got = tlegacy.homo_warping(*(torch.from_numpy(a) for a in (
        fea, src_P, ref_P, ref_depth)))
    want = jlegacy.homo_warping(*(jnp.asarray(a) for a in (
        fea, src_P, ref_P, ref_depth)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the skew: some taps leave the map and read zeros
    assert (got.numpy() == 0).all(-1).any()


@pytest.mark.parametrize("composed", [False, True])
def test_filter_depth_matches_jax(composed):
    ref_depth, src_depths, ref_proj, src_projs = make_scene()
    if composed:
        ref_proj = np.array(jlegacy.compose_proj(ref_proj))
        src_projs = np.array(jlegacy.compose_proj(src_projs))
    got = tlegacy.filter_depth(*(torch.from_numpy(a) for a in (
        ref_depth, src_depths, ref_proj, src_projs)))
    want = jlegacy.filter_depth(*(jnp.asarray(a) for a in (
        ref_depth, src_depths, ref_proj, src_projs)))
    scale = float(np.abs(np.asarray(want[1])).max())
    for name, g, w in zip(("ref_pc", "aligned", "dist"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
