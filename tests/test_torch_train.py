"""The port's training pieces against the JAX package on the CPU: grouped
train-mode BN and its running statistics, channel dropout, ``mvs_loss``
and the metrics, the one-cycle schedule, one AdamW step, the gradients of
forward + ``mvs_loss`` on ``model_dtu.npz``, and one full train step.

Tolerances: BN outputs 2e-5 and running stats 1e-5 (those of
tests/test_bn_stat_groups.py); loss and metrics rtol 1e-5; the schedule
rtol 1e-5 (JAX evaluates it in float32, the port in float64); AdamW
rtol 1e-5; gradients as tests/test_grad_parity.py: loss rtol 2e-4, every
leaf rel-l2 < 5e-2 with cosine > 0.999, and the 90th percentile of rel-l2
< 1e-2 (fp32 through 13 predictions and 9 GRU iterations under heavy
cancellation); the train step's metrics rtol 2e-4, its weights as stated
in the test, its BN running statistics rtol 1e-4.  Dropout is off on both sides in
the gradient and train-step comparisons: the two random streams cannot
match."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from effi_mvs_plus_tpu import nn as jnn
from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load_npz
from effi_mvs_plus_tpu.models import EffiMVSConfig as JaxConfig
from effi_mvs_plus_tpu.models import forward as jax_forward
from effi_mvs_plus_tpu.train import loss as jloss
from effi_mvs_plus_tpu.train import optim as joptim
from effi_mvs_plus_tpu.train import trainer as jtrainer
from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint, params_from_jax
from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
from effi_mvs_plus_tpu_torch.train import loss as tloss
from effi_mvs_plus_tpu_torch.train import optim as toptim
from effi_mvs_plus_tpu_torch.train import trainer as ttrainer

from test_torch_model import CKPT, H, W, make_inputs

LR, TOTAL = 1e-3, 100


# ---------------------------------------------------------------- BN

def _bn_params(C, rng):
    return {"weight": rng.normal(1.0, 0.1, C).astype(np.float32),
            "bias": rng.normal(0.0, 0.1, C).astype(np.float32),
            "running_mean": rng.normal(0, 1, C).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, C).astype(np.float32)}


@pytest.mark.parametrize("shape,groups", [((3, 4, 6, 5, 7), 4),
                                          ((2, 3, 5, 6, 7, 3), 3),
                                          ((5, 1, 4, 3, 2), 1)])
def test_train_bn_matches_jax_stat_groups(shape, groups):
    """Ragged dims, 2-D and 3-D maps; x is (B, G, ..., C) flattened."""
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    x = x.reshape((shape[0] * shape[1],) + shape[2:])
    p = _bn_params(C, rng)
    ctx = jnn.Ctx(train=True, rng=jax.random.PRNGKey(0))
    with ctx.scope("bn"), ctx.stat_groups(groups):
        want = np.asarray(jnn.batch_norm(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, ctx))

    bn = nn.BatchNorm(C)
    bn.load_state_dict({**{k: torch.from_numpy(v) for k, v in p.items()},
                        "num_batches_tracked": torch.zeros((),
                                                           dtype=torch.long)})
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt, groups)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(ctx.updates["bn"][k]),
                                   rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == groups

    # gradients through the batch statistics, as jax.grad takes them
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    got.backward(torch.from_numpy(gy))

    def f(xx):
        c = jnn.Ctx(train=True, rng=jax.random.PRNGKey(0))
        with c.scope("bn"), c.stat_groups(groups):
            y = jnn.batch_norm(xx, {k: jnp.asarray(v) for k, v in p.items()},
                               c)
        return jnp.sum(y * gy)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(jax.grad(f)(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)


def test_eval_bn_leaves_running_stats():
    bn = nn.BatchNorm(4).eval()
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    bn(torch.randn(2, 3, 3, 4))
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k


# ----------------------------------------------------------- dropout

def test_channel_dropout_semantics():
    p = 0.1
    drop = nn.ChannelDropout(p).train()
    x = torch.ones(64, 5, 6, 96)
    nn.use_generator(drop, torch.Generator().manual_seed(3))
    y = drop(x)
    nn.use_generator(drop, torch.Generator().manual_seed(3))
    y2 = drop(x)
    assert torch.equal(y, y2), "same generator seed, same mask"
    # one keep/drop per (sample, channel), shared over the map
    assert torch.equal(y, y[:, :1, :1].expand_as(y))
    kept = y[:, 0, 0] != 0
    assert torch.allclose(y[:, 0, 0][kept], torch.tensor(1 / (1 - p)))
    n = kept.numel()
    # keep rate within 4 binomial standard deviations of 1 - p
    assert abs(kept.float().mean() - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5
    nn.use_generator(drop, torch.Generator().manual_seed(4))
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


# ------------------------------------------------- softmax, sigmoid

def test_fp32_softmax_and_sigmoid_match_jax_with_finite_gradients():
    """fp32 values as jax.nn's (rtol 1e-6), and the sigmoid's gradient as
    jax.grad's, finite where exp(-x) overflows."""
    x = np.random.default_rng(5).uniform(-4, 4, (3, 8, 5)).astype(
        np.float32)
    np.testing.assert_allclose(nn.softmax(torch.from_numpy(x), 1).numpy(),
                               jax.nn.softmax(jnp.asarray(x), axis=1),
                               rtol=1e-6, atol=1e-7)
    z = np.array([-100, -50, -1, 0, 2, 50, 100], np.float32)
    zt = torch.from_numpy(z).requires_grad_()
    y = nn.sigmoid(zt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jax.nn.sigmoid(z),
                               rtol=1e-6, atol=1e-30)
    assert torch.isfinite(zt.grad).all()
    np.testing.assert_allclose(
        zt.grad.numpy(), jax.grad(lambda a: jax.nn.sigmoid(a).sum())(z),
        rtol=1e-5, atol=1e-30)


# ------------------------------------------------------ loss, metrics

def _loss_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    shapes = {1: (8, 12), 2: (16, 24), 3: (32, 48), 4: (64, 96)}
    gt = {f"stage{k}": rng.uniform(400, 900, (B,) + s).astype(np.float32)
          for k, s in shapes.items()}
    mask = {f"stage{k}": (rng.uniform(0, 1, (B,) + s) > 0.3).astype(
        np.float32) for k, s in shapes.items()}
    preds = [(gt[f"stage{s}"] + rng.normal(0, 3, gt[f"stage{s}"].shape))
             .astype(np.float32) for s in jloss.PRED_STAGE_MAP]
    return preds, gt, mask


@pytest.mark.parametrize("loss_rate", [1.0, 0.9])
def test_mvs_loss_matches_jax(loss_rate):
    preds, gt, mask = _loss_inputs()
    t = torch.from_numpy
    got, got_per = tloss.mvs_loss([t(p) for p in preds],
                                  {k: t(v) for k, v in gt.items()},
                                  {k: t(v) for k, v in mask.items()},
                                  loss_rate)
    want, want_per = jloss.mvs_loss([jnp.asarray(p) for p in preds], gt,
                                    mask, loss_rate)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert sorted(got_per) == sorted(want_per)
    for k in want_per:
        np.testing.assert_allclose(float(got_per[k]), float(want_per[k]),
                                   rtol=1e-5)


def test_metrics_match_jax():
    preds, gt, mask = _loss_inputs(seed=1)
    pred, g, m = preds[-1], gt["stage4"], mask["stage4"]
    t = torch.from_numpy
    pairs = [(tloss.abs_depth_error(t(pred), t(g), t(m)),
              jloss.abs_depth_error(pred, g, m))]
    for band in ((0.0, 2.0), (2.0, 4.0), (20.0, 1e5)):
        pairs.append((tloss.abs_depth_error(t(pred), t(g), t(m), band),
                      jloss.abs_depth_error(pred, g, m, band)))
    for th in (0.125, 2.0, 4.0, 8.0):
        pairs.append((tloss.threshold_error(t(pred), t(g), t(m), th),
                      jloss.threshold_error(pred, g, m, th)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------------- schedule, AdamW

def test_schedule_matches_onecycle_linear_every_step():
    total = 200
    want = joptim.onecycle_linear(LR, total)
    m = torch.nn.Linear(2, 2)
    opt, scheduler, sched = toptim.make_optimizer(m, LR, total)
    for step in range(total):
        np.testing.assert_allclose(sched(step), float(want(step)), rtol=1e-5)
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(step)), rtol=1e-5)
        opt.step()
        scheduler.step()


def test_adamw_step_matches_optax():
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 1, 3).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx, _ = joptim.make_optimizer(LR, TOTAL, weight_decay=1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    module = torch.nn.Module()
    for k, v in tp.items():
        module.register_parameter(k, v)
    opt, scheduler, _ = toptim.make_optimizer(module, LR, TOTAL,
                                              weight_decay=1e-3)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        opt.step()
        scheduler.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


# --------------------------------------------- gradients, train step

def _gt_pyramid(B=1, seed=5):
    rng = np.random.default_rng(seed)
    gt = {}
    for stage, s in (("stage1", 8), ("stage2", 4), ("stage3", 2),
                     ("stage4", 1)):
        base = rng.uniform(450, 900)
        yy, xx = np.meshgrid(np.linspace(0, 1, H // s),
                             np.linspace(0, 1, W // s), indexing="ij")
        gt[stage] = np.broadcast_to(
            base + 60 * np.sin(3 * xx) * np.cos(2 * yy),
            (B, H // s, W // s)).astype(np.float32)
    mask = {k: (v > 470).astype(np.float32) for k, v in gt.items()}
    return gt, mask


def _batch():
    imgs, proj_ms, dv = make_inputs()
    gt, mask = _gt_pyramid()
    return {"imgs": imgs, "proj_matrices": proj_ms, "depth_values": dv,
            "depth": gt, "mask": mask}


def _port_model():
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(load_npz_checkpoint(CKPT["dtu"]), strict=True)
    for m in model.modules():                     # deterministic: no dropout
        if isinstance(m, nn.ChannelDropout):
            m.p = 0.0
    return model


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jnn, "dropout", lambda x, rate, ctx: x)


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _compare_grads(got, want):
    """got, want: {state-dict name: array} over the trainable leaves."""
    rels = []
    for name, w in want.items():
        g = np.asarray(got[name], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        if np.abs(w).max() == 0:
            assert np.abs(g).max() < 1e-7, name
            continue
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert rel < 5e-2 and cos > 0.999, f"{name}: rel-l2 {rel:.2e} " \
            f"cos {cos:.6f}"
        rels.append(rel)
    assert len(rels) > 100, len(rels)
    rels.sort()
    assert rels[int(0.9 * len(rels))] < 1e-2, rels[int(0.9 * len(rels))]


def test_gradients_match_jax_value_and_grad(no_jax_dropout):
    batch = _batch()
    model = _port_model().train()
    tb = ttrainer.batch_to_device(batch, torch.device("cpu"))
    out = model(tb["imgs"], tb["proj_matrices"], tb["depth_values"])
    loss, _ = tloss.mvs_loss(out["depth"], tb["depth"], tb["mask"])
    loss.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert all(p.grad is not None for p in model.parameters())

    params = jax_load_npz(CKPT["dtu"])

    def loss_fn(p):
        ctx = jnn.Ctx(train=True, rng=jax.random.PRNGKey(0))
        o = jax_forward(p, jnp.asarray(batch["imgs"]),
                        {k: jnp.asarray(v)
                         for k, v in batch["proj_matrices"].items()},
                        jnp.asarray(batch["depth_values"]), JaxConfig(), ctx)
        return jloss.mvs_loss(o["depth"], batch["depth"], batch["mask"])[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-4)
    # the relayout of params_from_jax is linear: it maps gradients too
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    _compare_grads(got, {n: want[n].numpy() for n in got})


def test_train_step_matches_jax(no_jax_dropout):
    batch = _batch()
    model = _port_model()
    opt, scheduler, _ = toptim.make_optimizer(model, LR, TOTAL)
    step = ttrainer.make_train_step(model, opt, scheduler, device="cpu")
    got = step(batch)

    params = jax_load_npz(CKPT["dtu"])
    tx, _ = joptim.make_optimizer(LR, TOTAL, weight_decay=1e-3,
                                  params=params)
    jstep = jtrainer.make_train_step(JaxConfig(), tx)
    jparams, _, want = jstep(params, tx.init(params),
                             jax.tree.map(jnp.asarray, batch),
                             jax.random.PRNGKey(0))

    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    sd = model.state_dict()
    want_sd = params_from_jax(jax.tree.map(np.asarray, jparams))
    before = load_npz_checkpoint(CKPT["dtu"])
    # Adam's first step moves each weight by lr0 * g/(|g| + eps), about
    # +-lr0 whatever |g| is, so a weight whose two gradients (equal within
    # the tolerance above) straddle 0 moves the other way: allow 1e-3 of
    # the weights to differ, each by no more than the 2 lr0 of a flip
    # (measured: 116 of 759,100)
    lr0 = toptim.onecycle_linear(LR, TOTAL)(0)
    n_far = n = 0
    for name in dict(model.named_parameters()):
        moved = (sd[name] - before[name]).numpy()
        diff = np.abs(moved - (want_sd[name] - before[name]).numpy())
        assert diff.max() <= 2.05 * lr0, name
        assert np.abs(moved).max() > 0.5 * lr0, name
        n_far += int((diff > 0.05 * lr0).sum())
        n += moved.size
    assert n_far < 1e-3 * n, (n_far, n)
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(),
                                       want_sd[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("nd,transpose,bias", [(2, False, True),
                                               (3, False, False),
                                               (3, True, False)])
def test_fresh_layers_take_torch_default_init(nd, transpose, bias):
    """Training from scratch: each convolution starts as torch's own
    ``ConvNd`` / ``ConvTransposeNd`` would (the JAX package's
    ``init_params``), and BN as torch's BatchNorm."""
    cls = {(2, False): torch.nn.Conv2d, (3, False): torch.nn.Conv3d,
           (3, True): torch.nn.ConvTranspose3d}[(nd, transpose)]
    torch.manual_seed(0)
    ours = nn.Conv(nd, 6, 5, 3, bias=bias, transpose=transpose)
    torch.manual_seed(0)
    want = cls(6, 5, 3, bias=bias)
    assert torch.equal(ours.weight, want.weight)
    if bias:
        assert torch.equal(ours.bias, want.bias)
    bn, tbn = nn.BatchNorm(5), torch.nn.BatchNorm2d(5)
    for k, v in tbn.state_dict().items():
        assert torch.equal(bn.state_dict()[k], v), k
