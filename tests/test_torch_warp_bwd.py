"""The backward of the port's warp + correlation on the CPU (autograd of
``cuda_warp._views_torch``, the plain version beside the kernel K3)
against ``jax.vjp`` of the JAX package's XLA path ``pallas_warp._views_xla``
— not its Pallas backward, which can pick another window rung than its
own forward.  Shapes and rigs of tests/test_torch_warp.py: an ordinary
rig, one that leaves the image and one that sees hypotheses from behind.
Tolerance: |got - want| <= 1e-4 * max(1, max |want|), per gradient; and a
float64 gradcheck on a tiny shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.ops import pallas_warp as pw
from effi_mvs_plus_tpu_torch.ops import cuda_warp

from test_torch_warp import RIGS, SHAPES, _inputs


def _port_grads(ref, srcs, rots, trs, depth, g):
    t = torch.from_numpy
    r = t(ref).requires_grad_()
    s = t(srcs).requires_grad_()
    out = cuda_warp.warp_correlate_views(r, s, t(rots), t(trs), t(depth))
    out.backward(t(g))
    return r.grad.numpy(), s.grad.numpy()


def _jax_grads(ref, srcs, rots, trs, depth, g):
    _, vjp = jax.vjp(lambda rf, sf: pw._views_xla(
        rf, sf, jnp.asarray(rots), jnp.asarray(trs), jnp.asarray(depth), 1),
        jnp.asarray(ref), jnp.asarray(srcs))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rig", sorted(RIGS))
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_vjp(shape, rig):
    H, W, C, D, V = shape
    ref, srcs, rots, trs, depth = _inputs(H, W, C, D, V, rig, seed=2)
    g = np.random.default_rng(3).normal(size=(1, V, D, H, W)).astype(
        np.float32)
    got = _port_grads(ref, srcs, rots, trs, depth, g)
    want = _jax_grads(ref, srcs, rots, trs, depth, g)
    for name, a, b in zip(("d_ref", "d_src"), got, want):
        assert a.shape == b.shape, name
        scale = max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} (scale {scale:.3g})"
    if rig == "off_image":
        # taps outside the image get no gradient: some source pixels none
        assert (got[1][0, -1] == 0).all(axis=-1).any()


def test_model_hands_the_warp_no_geometry_gradient(monkeypatch):
    """In a train-mode forward the depths, rotations and translations that
    reach the warp carry no gradient (the depths are detached, the
    cameras take none), so the CUDA Function, which returns None for
    them, drops nothing; the features do carry one."""
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from test_torch_model import make_inputs
    seen = []
    plain = cuda_warp.warp_correlate_views

    def spy(ref, src, rots, trs, depth, y0=0):
        seen.append((ref.requires_grad, src.requires_grad,
                     rots.requires_grad, trs.requires_grad,
                     depth.requires_grad))
        return plain(ref, src, rots, trs, depth, y0)
    monkeypatch.setattr(cuda_warp, "warp_correlate_views", spy)
    imgs, proj_ms, dv = make_inputs()
    torch.manual_seed(0)
    model = EffiMVS(EffiMVSConfig()).train()
    out = model(torch.from_numpy(imgs),
                {k: torch.from_numpy(v) for k, v in proj_ms.items()},
                torch.from_numpy(dv))
    assert out["depth"][-1].requires_grad
    assert seen == [(True, True, False, False, False)] * 3


def test_gradcheck_float64():
    ref, srcs, rots, trs, depth = _inputs(5, 7, 8, 2, 2, "off_image")
    t = torch.from_numpy

    def f(r, s):
        return cuda_warp.warp_correlate_views(r, s, t(rots).double(),
                                              t(trs).double(),
                                              t(depth).double())
    r = t(ref).double().requires_grad_()
    s = t(srcs).double().requires_grad_()
    assert torch.autograd.gradcheck(f, (r, s), eps=1e-6, atol=1e-7)
