"""The decomposition of the warp + correlation kernels K1 and K3
(``csrc/warp_window.cuh``) on the CPU, through its plain-PyTorch emulation
in ``ops/warp_window.py`` (``window_correlate``, ``window_correlate_bwd``,
on the chunk and window budget ``window_plan`` gives the launches): 8x16
tiles, hypothesis chunks, the bounding-box window of each block clipped to
its budget, taps inside it served from the staged copy and taps outside
from the source map, K3's per-view d_ref partials summed in order and its
d_src accumulated in the windows and flushed.

Each case holds the emulation against the plain version
(``_views_torch`` and its autograd; atol 1e-5 * max(1, max |plain|), fp32)
and against the JAX package's XLA path (``pallas_warp._views_xla`` and
``jax.vjp`` of it, as tests/test_torch_warp.py and
tests/test_torch_warp_bwd.py do; atol 1e-4 * max(1, max |want|)), both
made once for the three budgets of a case and the XLA path compiled, on
ragged tiles and chunks, two batch items, an ordinary rig, one that leaves
the image and one that sees hypotheses from behind, C = 8, 16, 32, the
expanded stage-1 sweep and per-pixel depths, at the launches' window
budget (none for K1's small texels), at 150 texels and at six, where
most taps fall outside."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.ops import pallas_warp as pw
from effi_mvs_plus_tpu_torch.ops import cuda_warp, warp_window

from test_torch_warp import _inputs

# 3x3 tiles, the last row and column ragged; chunks of 16 + 4 (K1) and
# 8 + 8 + 4 (K3) hypotheses
B, H, W, D, V = 2, 20, 40, 20, 2


def _case(rig, C, depth_kind, seed=4):
    ref, srcs, rots, trs, depth = _inputs(H, W, C, D, V, rig, seed=seed, B=B)
    t = torch.from_numpy
    if depth_kind == "sweep":
        # the stage-1 sweep as the model hands it: an expanded view
        dep = t(np.ascontiguousarray(depth[:, :, :1, :1])).expand(B, D, H, W)
    else:
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        bump = 40.0 * np.sin(xx / 6.0) * np.cos(yy / 4.0)
        sign = np.array([1.0, -0.5], np.float32)[:, None, None, None]
        dep = t(np.ascontiguousarray(depth + bump[None, None] * sign))
    g = np.random.default_rng(seed + 1).normal(size=(B, V, D, H, W)).astype(
        np.float32)
    return t(ref), t(srcs), t(rots), t(trs), dep, t(g)


def _close(got, want, atol, what):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= atol * scale, f"{what}: {err:.3e} (scale {scale:.3g})"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the emulation runs thousands of
    tiny ops, whose parallel regions wait on each other's threads on a
    host shared with other test workers (six cases: 43 s against 7 s
    beside seven busy processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jax.jit
def _xla_and_vjp(ref, srcs, rots, trs, depth, g):
    """``pw._views_xla`` and its vjp at g, compiled once a shape."""
    want, vjp = jax.vjp(
        lambda rf, sf: pw._views_xla(rf, sf, rots, trs, depth, 1), ref, srcs)
    return (want, *vjp(g))


_REFERENCES = {}


def _references(rig, C, depth_kind):
    """The case's inputs, its plain version with its autograd, and the JAX
    package's XLA path with its vjp, made once per (rig, C, depth_kind):
    neither depends on the window budget."""
    key = (rig, C, depth_kind)
    if key not in _REFERENCES:
        inputs = _case(rig, C, depth_kind)
        ref, srcs, rots, trs, depth, g = inputs
        r, s = ref.clone().requires_grad_(), srcs.clone().requires_grad_()
        plain = cuda_warp._views_torch(r, s, rots, trs, depth)
        plain.backward(g)
        jax_ = [torch.from_numpy(np.array(w)) for w in _xla_and_vjp(
            *(jnp.asarray(a.contiguous().numpy()) for a in inputs))]
        _REFERENCES[key] = inputs, (plain.detach(), r.grad, s.grad), jax_
    return _REFERENCES[key]


@pytest.mark.parametrize("cap", [None, 150, 6],
                         ids=["budget", "150_texels", "six_texels"])
@pytest.mark.parametrize("depth_kind", ["sweep", "per_pixel"])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("rig", ["ordinary", "off_image", "behind"])
def test_window_decomposition_matches_plain_and_jax(rig, C, depth_kind, cap):
    (ref, srcs, rots, trs, depth, g), plain, jax_ = _references(
        rig, C, depth_kind)
    corr, fstats = warp_window.window_correlate(ref, srcs, rots, trs, depth,
                                              cap=cap)
    d_ref, d_src, bstats = warp_window.window_correlate_bwd(
        ref, srcs, rots, trs, depth, g, cap=cap)

    # the plain version and its autograd
    for name, got, want in zip(("corr", "d_ref", "d_src"),
                               (corr, d_ref, d_src), plain):
        _close(got, want, 1e-5, f"{name} vs plain")

    # the JAX package's XLA path and its vjp
    for name, got, want in zip(("corr", "d_ref", "d_src"),
                               (corr, d_ref, d_src), jax_):
        _close(got, want, 1e-4, f"{name} vs JAX")

    # every in-image tap is served once, from a window or from the map
    assert fstats["window"] + fstats["device"] > 0
    assert bstats["window"] + bstats["device"] \
        == (fstats["window"] + fstats["device"]) * C
    if cap == 6:
        # six texels cannot hold a chunk's footprint: most taps overflow
        assert fstats["device"] > fstats["window"] > 0
        assert bstats["device"] > bstats["window"] > 0
    elif cap is None and rig == "ordinary" and C >= 16:
        assert fstats["device"] == 0
    assert bstats["flush"] <= bstats["window"]
    assert (bstats["flush"] > 0) == (bstats["window"] > 0)


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_plan_fits_the_kernels(C, dtype):
    """Chunks of at most 16 (K1) and 8 (K3) hypotheses; K1's texel stride
    an odd number of 16-byte units (bank-conflict free 16-byte loads), its
    two windows and K3's records and window under the kernels' 200 KB of
    dynamic shared memory and small enough for three blocks an SM."""
    esz = torch.empty((), dtype=dtype).element_size()
    stride = cuda_warp._window_stride(C, esz)
    assert stride >= C and (stride * esz) % 32 == 16
    for D in (5, 8, 48, 96):
        dc, cap = cuda_warp.window_plan("fwd", C, dtype, D)
        assert dc == min(D, cuda_warp.K1_CHUNK)
        # windows for sweeps of more than a chunk and texels of 64+ bytes
        assert (cap > 0) == (D > cuda_warp.K1_CHUNK and C * esz >= 64)
        assert 2 * cap * stride * esz <= 227 * 1024 // 3
        dc, cap = cuda_warp.window_plan("bwd", C, dtype, D)
        assert dc == min(D, cuda_warp.K3_CHUNK) <= 8
        assert dc * cuda_warp.TILE_H * cuda_warp.TILE_W * 24 + cap * C * 4 \
            <= 227 * 1024 // 3
    with pytest.raises(ValueError):
        cuda_warp.window_plan("sideways", C, dtype, 8)
