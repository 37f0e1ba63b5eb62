"""The port in bf16 against the JAX package in bf16, on the CPU, with the
``model_dtu.npz`` weights: block by block (FPN, PixelwiseNet, cost
regulariser, CSP, the update block's encoder, GRU, head and mask), the
bf16 softmax and sigmoid, then the full forward on the seeded 96x128,
V=3 scene of tests/test_torch_model.py.

Criterion: the port-bf16 against JAX-bf16 error is measured against the
JAX package's own bf16 error, JAX-bf16 against JAX-fp32 on the same
bf16-valued inputs (max abs error; over a depth map's range for the
maps, which divides both sides alike).

* Blocks: no larger than the JAX bf16 error.  Both sides round at the
  same places (bias added after the convolution, softmax and sigmoid op
  by op); a bf16 convolution's fp32 accumulator is summed in another
  order by oneDNN and XLA, which flips the rounding of about 3e-5 of the
  outputs by one bf16 ulp.
* Full forward, per map (scripts/diag_torch_bf16.py prints the
  measured values).  The forward on noise images is chaotic in bf16: one
  bf16 ulp in one input pixel moves the JAX package's own bf16 maps by
  21-173 mm at most and 8.5-13.5 mm in the median, so the one-ulp flips
  above grow to errors of the size of the bf16 error itself.  Hence
  - max error no larger than 3x the JAX bf16 error (measured worst 2.45x,
    map 8), and no larger than 30% of the sweep's depth range (153 mm;
    measured worst 97 mm, map 0), which an arbitrary in-range map misses;
  - median error no larger than 2x the median move of that one-ulp nudge
    (measured worst 1.45x, map 4);
  - the port's bf16 maps differ from its own fp32 maps by more than 1 mm
    in the median (measured 9.8-24.4 mm): the port really computes in
    bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load_npz
from effi_mvs_plus_tpu.models import EffiMVSConfig as JaxConfig
from effi_mvs_plus_tpu.models import blocks as jb
from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model

from test_torch_model import CKPT, make_inputs, run_jax, run_port

BF = jnp.bfloat16


@pytest.fixture(scope="module")
def nets():
    model = build_model(load_npz_checkpoint(CKPT["dtu"]),
                        EffiMVSConfig(compute_dtype=torch.bfloat16),
                        device="cpu")
    return model, jax_load_npz(CKPT["dtu"])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check_block(port_fn, jax_fn, *inputs):
    """port(bf16) vs jax(bf16) <= jax(bf16) vs jax(fp32), per output."""
    xs = [jnp.asarray(a).astype(BF) for a in inputs]
    with torch.no_grad():
        got = port_fn(*[torch.from_numpy(np.array(_f32(a))).bfloat16()
                        for a in xs])
    want = jax_fn(*xs)
    ref32 = jax_fn(*[a.astype(jnp.float32) for a in xs])
    if isinstance(want, dict):
        got, want, ref32 = ([d[k] for k in sorted(want)]
                            for d in (got, want, ref32))
    elif isinstance(want, tuple):
        got, want, ref32 = got[:1], want[:1], ref32[:1]
    else:
        got, want, ref32 = [got], [want], [ref32]
    for g, w, r in zip(got, want, ref32):
        assert g.dtype == torch.bfloat16
        err = np.abs(_f32(g) - _f32(w)).max()
        budget = np.abs(_f32(w) - _f32(r)).max()
        assert err <= budget, (err, budget)


def _u(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_fpn_bf16(nets):
    model, P = nets
    x = _u(np.random.default_rng(0), 2, 48, 64, 3, lo=0.0)
    for name in ("feature", "cnet_depth"):
        _check_block(getattr(model, name),
                     lambda a, n=name: jb.feature_net(a, P[n]), x)


def test_pixelwise_net_bf16(nets):
    model, P = nets
    e = _u(np.random.default_rng(1), 3, 12, 16, 1, lo=0.0, hi=4.0)
    _check_block(model.PixelwiseNet,
                 lambda a: jb.pixelwise_net(a, P["PixelwiseNet"]), e)


def test_cost_reg_and_csp_bf16(nets):
    model, P = nets
    rng = np.random.default_rng(2)
    v = _u(rng, 1, 8, 12, 16, 1)
    _check_block(model.cost_regularization,
                 lambda a: jb.cost_reg_net(a, P["cost_regularization"]), v)
    pv = _u(rng, 1, 8, 6, 8, 1)
    _check_block(model.CSP_R1, lambda a, b: jb.csp_block(a, b, P["CSP_R1"]),
                 v, pv)


@pytest.mark.parametrize("stage", [1, 3])
def test_update_block_parts_bf16(nets, stage):
    model, P = nets
    ub = getattr(model, f"update_block_depth{stage}")
    p = P[f"update_block_depth{stage}"]
    hd, cd = (48, 12) if stage == 1 else (16, 4)
    rng = np.random.default_rng(3)
    disp, cost = _u(rng, 2, 10, 12, 1, lo=0.0), _u(rng, 2, 10, 12, 6)
    ctx, h = _u(rng, 2, 10, 12, cd, lo=0.0), _u(rng, 2, 10, 12, hd)
    _check_block(ub.encoder,
                 lambda a, b, c: jb.projection_input(a, b, c, p["encoder"]),
                 disp, cost, ctx)
    _check_block(ub.depth_gru,
                 lambda a, b: jb.gru_step(a, b, p["depth_gru"], impl="xla"),
                 h, np.tanh(h))
    _check_block(ub.depth_head, lambda a: jb.depth_head(a, p["depth_head"]),
                 h)
    _check_block(ub.upsample_mask, lambda a: jb.upsample_mask(a, p), h)


def test_softmax_and_sigmoid_round_as_jax():
    """In bf16 the port's softmax and sigmoid round at each step as XLA's
    do; torch.softmax and torch.sigmoid would round once."""
    x = _u(np.random.default_rng(4), 2, 48, 12, 16, lo=-3.0, hi=3.0)
    xj = jnp.asarray(x).astype(BF)
    xt = torch.from_numpy(_f32(xj)).bfloat16()
    for got, want in ((nn.softmax(xt, 1), jax.nn.softmax(xj, axis=1)),
                      (nn.sigmoid(xt), jax.nn.sigmoid(xj))):
        assert (_f32(got) != _f32(want)).mean() < 1e-3


def test_full_forward_bf16(nets):
    model, P = nets
    imgs, proj_ms, dv = make_inputs()
    got, _ = run_port(model, imgs, proj_ms, dv)
    got32, _ = run_port(build_model(load_npz_checkpoint(CKPT["dtu"]),
                                    EffiMVSConfig(), device="cpu"),
                        imgs, proj_ms, dv)
    want, _ = run_jax(P, JaxConfig(compute_dtype=BF), imgs, proj_ms, dv)
    ref32, _ = run_jax(P, JaxConfig(), imgs, proj_ms, dv)
    nudged = imgs.copy()
    v = float(jnp.asarray(nudged[0, 0, 40, 60, 1]).astype(BF))
    nudged[0, 0, 40, 60, 1] = v * (1 + 2.0 ** -7)     # one bf16 ulp up
    chaos, _ = run_jax(P, JaxConfig(compute_dtype=BF), nudged, proj_ms, dv)
    cap = 0.3 * (1.0 / dv[0, 0] - 1.0 / dv[0, -1])    # dv ascends
    assert len(got) == len(want) == 13
    for i, (g, w, r) in enumerate(zip(got, want, ref32)):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        span = r.max() - r.min()
        err = np.abs(g - w).max() / span
        budget = np.abs(w - r).max() / span
        assert err <= 3.0 * budget, f"map {i}: {err:.4f} vs {budget:.4f}"
        assert err * span <= cap, f"map {i}: {err * span:.1f} mm > {cap:.1f}"
        med = np.median(np.abs(g - w))
        med_chaos = np.median(np.abs(chaos[i] - w))
        assert med <= 2.0 * med_chaos, f"map {i}: median {med} {med_chaos}"
        assert np.median(np.abs(g - got32[i])) > 1.0, f"map {i} is fp32"
