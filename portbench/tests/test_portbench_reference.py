"""The frozen reference against the port's plain CPU path at a tiny
size: the forward in eval mode, and training steps (train-mode BN, the
dropout masks drawn from one generator in the same order, AdamW on the
one-cycle schedule)."""

import numpy as np
import pytest
import torch

from portbench.lib import registry, scene
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference import weights as ref_weights

from effi_mvs_plus_tpu_torch.io import load_state_dict
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model

CKPT = str(registry.ROOT / "checkpoints" / "model_dtu.npz")
CPU = torch.device("cpu")


def _batch(tiny, name, B, with_depth=False):
    cfg = registry.config(name, tiny)
    inp = cfg["input"]
    return cfg, scene.render_batch(cfg["scene"], B, inp["views"],
                                   inp["height"], inp["width"], 2 ** 31 + 3,
                                   0, CPU, with_depth)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def test_weights_fold_the_aliases():
    w = ref_weights.load_npz(CKPT)
    assert "update_block_depth1.depth_gru.convz.weight" in w
    assert not any(k.startswith(("update_block.", "CSP_R.", "CSP_C."))
                   for k in w)
    assert ref_weights.canonical("CSP_C.1.conv0.bn.bias") == \
        "CSP_C2.conv0.bn.bias"
    n = sum(a.size for k, a in w.items() if ref_weights.is_parameter(k))
    assert n == 759100


def test_forward_matches_the_port(tiny):
    cfg, batch = _batch(tiny, "dtu_eval", 2)
    model = build_model(load_state_dict(CKPT), EffiMVSConfig(), CPU)
    b = _t(batch)
    with torch.no_grad():
        out = model(b["imgs"], b["proj_matrices"], b["depth_values"])
        counter = ref_model.Counter()
        preds, conf = ref_model.Reference(
            ref_weights.to_device(ref_weights.load_npz(CKPT), CPU),
            cfg["model"], counter=counter).forward(**b)
    assert len(preds) == 13
    for a, r in zip(out["depth"], preds):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-3)
    torch.testing.assert_close(out["photometric_confidence"], conf,
                               rtol=0, atol=1e-5)
    assert [w["stage"] for w in counter.warps] == [0, 1, 2]
    assert counter.fwd > 0 and counter.bwd == 0


def test_training_steps_match_the_port(tiny):
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
    from effi_mvs_plus_tpu_torch.train.trainer import make_train_step
    cfg, batch = _batch(tiny, "dtu_train", 2, with_depth=True)
    t = cfg["train"]
    model = build_model(load_state_dict(CKPT), EffiMVSConfig(), CPU)
    opt, sched, _ = make_optimizer(model, t["lr"], t["total_steps"],
                                   t["weight_decay"])
    step = make_train_step(model, opt, sched, t["loss_rate"], seed=5,
                           device=CPU)
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    params = ref_weights.to_device(ref_weights.load_npz(CKPT), CPU,
                                   trainable=True)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(5)
    trainer = ref_train.Trainer(params, cfg["model"], t, gen)
    ref = [trainer.step(_t(batch))[0] for _ in range(2)]
    assert losses[0] == pytest.approx(ref[0], rel=1e-6)
    assert losses[1] == pytest.approx(ref[1], rel=1e-4)
    named = dict(model.named_parameters())
    assert set(named) == set(trainer.m)
    worst = max(float((named[k].detach() - params[k].detach()).abs().max())
                for k in named)
    assert worst < 1e-4


def test_dropout_follows_the_generator():
    """Without the same generator state the reference's masks differ: the
    comparison sees the masks."""
    x = torch.ones(2, 4, 4, 48)
    draws = []
    for seed in (1, 1, 2):
        g = torch.Generator()
        g.manual_seed(seed)
        net = ref_model.Reference({}, dict(ndepths=[48, 8, 8], cost_num=3,
                                           gru_iters=[3, 3, 3],
                                           hdim=[48, 32, 16],
                                           interval_ratio=[4, 2, 1]),
                                  training=True, generator=g)
        draws.append(net.dropout(x))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert np.isclose(float(draws[0].mean()), 1.0, atol=0.3)
