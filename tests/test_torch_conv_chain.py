"""The stem chain K4's plain version and the fused-stem model on the CPU
against the JAX package: ``_chain_torch`` against
``pallas_conv.conv_bn_relu_chain(interpret=True)`` (fp32, atol 5e-5, the
JAX test's bound), ``fold_bn`` against JAX's, both FPNs with the fused stem
against JAX's ``feature_net`` with ``stem_impl='pallas'`` and ``'xla'`` on
``model_dtu.npz`` (atol 2e-4, JAX's own bound for the fused FPN), the
full forward with the fused stem against the JAX XLA forward at the
golden tolerance, and the choice between the fused chain and the unfused
blocks (``blocks.stem_chain_applies``).  The model fuses on the card only;
here ``fused_on_cpu`` lets the CPU take the same branch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load_npz
from effi_mvs_plus_tpu.models import EffiMVSConfig as JaxConfig
from effi_mvs_plus_tpu.models import blocks as jax_blocks
from effi_mvs_plus_tpu.ops import pallas_conv
from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, blocks, build_model
from effi_mvs_plus_tpu_torch.ops import cuda_conv
from effi_mvs_plus_tpu_torch.utils import profiling

from test_torch_model import (CKPT, NDEPTHS, assert_depths_close, make_inputs,
                              run_jax, run_port)


def _specs(rng, chans):
    """JAX (HWIO) and port (OIHW) copies of the same seeded layers."""
    jspecs, tspecs = [], []
    for ci, co in zip(chans[:-1], chans[1:]):
        w = (rng.standard_normal((3, 3, ci, co)) * 0.2).astype(np.float32)
        b = (rng.standard_normal(co) * 0.1).astype(np.float32)
        jspecs.append((jnp.asarray(w), jnp.asarray(b)))
        tspecs.append((torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(b)))
    return jspecs, tspecs


@pytest.mark.parametrize("B,H,W,chans", [(2, 13, 17, (3, 8, 8)),
                                         (1, 40, 9, (8, 16)),
                                         (1, 9, 11, (3, 8, 8, 16))])
def test_chain_matches_pallas_interpret(B, H, W, chans):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, chans[0])).astype(np.float32)
    jspecs, tspecs = _specs(rng, chans)
    want = pallas_conv.conv_bn_relu_chain(jnp.asarray(x), jspecs,
                                          interpret=True)
    got = cuda_conv.conv_bn_relu_chain(torch.from_numpy(x), tspecs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_chain_rounds_intermediates_to_the_input_dtype():
    """bf16: each layer's output is rounded to bf16, the weights too, the
    sums are fp32 (the TPU kernel's storage and MXU types)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 7, 9, 3)).astype(np.float32))
    _, specs = _specs(rng, (3, 8, 8))
    got = cuda_conv._chain_torch(x.bfloat16(), specs)
    assert got.dtype == torch.bfloat16
    y = x.bfloat16()
    for w, b in specs:
        y = torch.relu(nn.conv2d(y.float(), w.bfloat16().float(), b,
                                 padding=1)).bfloat16()
    assert torch.equal(got, y)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    stats = {k: rng.uniform(0.5, 1.5, 6).astype(np.float32)
             for k in ("weight", "bias", "running_mean", "running_var")}
    cb = rng.standard_normal(6).astype(np.float32)
    jw, jb = pallas_conv.fold_bn(jnp.asarray(w),
                                 {k: jnp.asarray(v) for k, v in stats.items()},
                                 conv_bias=jnp.asarray(cb))
    bn = nn.BatchNorm(6)
    with torch.no_grad():
        for k, v in stats.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
        tw, tb = cuda_conv.fold_bn(torch.from_numpy(w.transpose(3, 2, 0, 1)),
                                   bn, conv_bias=torch.from_numpy(cb))
    np.testing.assert_allclose(tw.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


@pytest.fixture(scope="module")
def fpn_models():
    sd = load_npz_checkpoint(CKPT["dtu"])
    return (build_model(sd, EffiMVSConfig(), device="cpu"),
            jax_load_npz(CKPT["dtu"]))


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The card's rule without its device test: fuse in eval mode with
    grad off."""
    monkeypatch.setattr(blocks, "stem_chain_applies", lambda x, training: not (
        training or torch.is_grad_enabled()))


@pytest.fixture
def chain_calls(monkeypatch):
    """Counts the model's calls of the stem chain (on the CPU the wrapper
    takes the plain version and launches nothing)."""
    calls = []
    real = cuda_conv.conv_bn_relu_chain

    def record(x, specs, packed=None):
        calls.append(len(specs))
        return real(x, specs, packed)
    monkeypatch.setattr(cuda_conv, "conv_bn_relu_chain", record)
    return calls


@pytest.mark.parametrize("net", ["feature", "cnet_depth"])
@pytest.mark.parametrize("stem_impl", ["pallas", "xla"])
def test_fused_feature_net_matches_jax(fpn_models, fused_on_cpu, chain_calls,
                                      net, stem_impl):
    model, params = fpn_models
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    want = jax_blocks.feature_net(jnp.asarray(x), params[net], None,
                                  stem_impl=stem_impl)
    n = profiling.counter("k4.launches")
    with torch.inference_mode():
        got = getattr(model, net)(torch.from_numpy(x))
    assert profiling.counter("k4.launches") == n  # the CPU takes the plain one
    assert chain_calls == [2] * 4
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, err_msg=k)


def test_fused_stem_forward_matches_jax_xla(fused_on_cpu, chain_calls):
    name = "tank"
    cfg = EffiMVSConfig(ndepths=NDEPTHS[name])
    model = build_model(load_npz_checkpoint(CKPT[name]), cfg, device="cpu")
    imgs, proj_ms, dv = make_inputs(seed=1)
    depths, conf = run_port(model, imgs, proj_ms, dv)
    assert chain_calls == [2] * 8             # 4 levels x 2 nets
    want_depths, want_conf = run_jax(jax_load_npz(CKPT[name]),
                                     JaxConfig(ndepths=NDEPTHS[name],
                                               stem_impl="xla"),
                                     imgs, proj_ms, dv)
    assert_depths_close(depths, want_depths)
    assert np.abs(conf - want_conf).max() < 5e-3


def test_fused_stem_refuses_training_and_grad(monkeypatch, chain_calls):
    """The chain has no backward: a train-mode or grad-enabled forward runs
    the blocks one by one, as does any forward on the CPU; and the wrapper
    refuses an input that requires grad."""
    model = build_model(load_npz_checkpoint(CKPT["dtu"]), EffiMVSConfig(),
                        device="cpu")
    x = torch.rand((2, 16, 16, 3))
    with torch.no_grad():
        model.feature(x)
    assert chain_calls == []                  # the CPU runs the blocks
    monkeypatch.setattr(blocks, "stem_chain_applies", lambda x, training: not (
        training or torch.is_grad_enabled()))
    with torch.no_grad():
        fused = model.feature(x)
    assert chain_calls == [2] * 4
    unfused = model.feature(x)                # eval mode, grad enabled
    assert chain_calls == [2] * 4
    assert unfused["stage1"].requires_grad
    for k in fused:
        np.testing.assert_allclose(fused[k].numpy(),
                                   unfused[k].detach().numpy(), atol=2e-4)
    model.train()
    with torch.no_grad():
        model.feature(x)
    assert chain_calls == [2] * 4
    _, specs = _specs(np.random.default_rng(3), (3, 8, 8))
    with pytest.raises(ValueError, match="inference only"):
        cuda_conv.conv_bn_relu_chain(x.requires_grad_(), specs)
