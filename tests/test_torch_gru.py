"""The port's ConvGRU step (ops/cuda_gru.py) on the CPU against the JAX
package's ``pallas_gru.gru_step``: the Pallas kernel in interpret mode and
the XLA path, forward and backward.  Tolerance: max < 5e-4 and mean <
5e-6, fp32 summation-order noise, as in tests/test_pallas_gru.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.ops import pallas_gru as pg
from effi_mvs_plus_tpu_torch.models.blocks import ConvGRU
from effi_mvs_plus_tpu_torch.ops import cuda_gru


def _inputs(B, H, W, hd, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, H, W, hd)).astype(np.float32)
    x = rng.standard_normal((B, H, W, hd)).astype(np.float32)
    p = {k: {"weight": (rng.standard_normal((3, 3, 2 * hd, hd)) * 0.1
                        ).astype(np.float32),
             "bias": (rng.standard_normal(hd) * 0.1).astype(np.float32)}
         for k in ("convz", "convr", "convq")}
    return h, x, p


def _module(p, hd):
    """The port's ConvGRU holding the JAX (HWIO) weights as (O,I,3,3)."""
    m = ConvGRU(hd, hd)
    m.load_state_dict({f"{k}.{n}": torch.from_numpy(
        np.ascontiguousarray(v.transpose(3, 2, 0, 1)) if n == "weight" else v)
        for k, d in p.items() for n, v in d.items()})
    return m


def _jax_p(p):
    return {k: {n: jnp.asarray(v) for n, v in d.items()}
            for k, d in p.items()}


# the three stage widths (48/32/16) incl. a multi-strip case for the
# Pallas kernel, as in tests/test_pallas_gru.py
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("B,H,W,hd", [(2, 11, 13, 16), (1, 40, 12, 32),
                                      (2, 7, 9, 48)])
def test_gru_step_matches_jax(B, H, W, hd, impl):
    h, x, p = _inputs(B, H, W, hd)
    with torch.inference_mode():
        got = cuda_gru.gru_step(torch.from_numpy(h), torch.from_numpy(x),
                                _module(p, hd)).numpy()
    want = np.asarray(pg.gru_step(jnp.asarray(h), jnp.asarray(x), _jax_p(p),
                                  impl=impl, interpret=impl == "pallas"))
    assert got.shape == want.shape == h.shape
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 5e-6, (d.max(), d.mean())


def test_gru_step_bf16_keeps_dtype():
    h, x, p = _inputs(1, 6, 7, 16)
    m = _module(p, 16)
    with torch.inference_mode():
        out = cuda_gru.gru_step(torch.from_numpy(h).bfloat16(),
                                torch.from_numpy(x).bfloat16(), m)
        ref = cuda_gru.gru_step(torch.from_numpy(h), torch.from_numpy(x), m)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max() < 5e-2


def _grads(fn, h, x, m, g):
    """Gradients of <fn(h, x), g> w.r.t. h, x and the module's weights."""
    ht = torch.from_numpy(h).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    fn(ht, xt, m).backward(torch.from_numpy(g))
    out = {"h": ht.grad.numpy(), "x": xt.grad.numpy()}
    for k in ("convz", "convr", "convq"):
        w = getattr(m, k)
        # (O,I,3,3) -> the JAX layout (3,3,I,O)
        out[f"{k}.weight"] = w.weight.grad.numpy().transpose(2, 3, 1, 0)
        out[f"{k}.bias"] = w.bias.grad.numpy()
    return out


@pytest.mark.parametrize("hd", [16, 32, 48])
def test_gru_step_backward_matches_jax_vjp(hd):
    """CPU autograd of the plain step against jax.vjp of the XLA path.
    Tolerance: max < 5e-4, as the forward."""
    h, x, p = _inputs(2, 9, 11, hd, seed=hd)
    g = np.random.default_rng(7).standard_normal(h.shape).astype(np.float32)
    got = _grads(cuda_gru.gru_step, h, x, _module(p, hd), g)
    _, vjp = jax.vjp(lambda hh, xx, pp: pg.gru_step(hh, xx, pp, impl="xla"),
                     jnp.asarray(h), jnp.asarray(x), _jax_p(p))
    dh, dx, dp = vjp(jnp.asarray(g))
    want = {"h": dh, "x": dx}
    for k in ("convz", "convr", "convq"):
        for n in ("weight", "bias"):
            want[f"{k}.{n}"] = dp[k][n]
    for k, w in want.items():
        d = np.abs(got[k] - np.asarray(w)).max()
        assert d < 5e-4, (k, d)


def test_cuda_function_backward_recomputes_the_plain_step(monkeypatch):
    """The CUDA path's autograd Function, its forward stood in by the
    plain step (no card here): its backward, which reruns the plain math,
    gives the gradients of autograd through the plain step."""
    h, x, p = _inputs(1, 6, 7, 16, seed=1)
    g = np.random.default_rng(8).standard_normal(h.shape).astype(np.float32)
    monkeypatch.setattr(cuda_gru, "_gru_cuda", cuda_gru._gru_torch)

    def via_function(hh, xx, m):
        return cuda_gru._ConvGRU.apply(
            hh, xx, m.convz.weight, m.convr.weight, m.convq.weight,
            m.convz.bias, m.convr.bias, m.convq.bias)
    got = _grads(via_function, h, x, _module(p, 16), g)
    want = _grads(cuda_gru.gru_step, h, x, _module(p, 16), g)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
