"""The port's train CLI on a logdir the JAX package wrote, on the CPU, at
``tests/test_torch_cli_train.py``'s tiny DTU rig (96x64 crops, 3 views,
B=7, 3 steps an epoch): ``--resume`` continues the JAX checkpoint of
epoch 0 (written by the JAX ``save_checkpoint`` after 3 optax updates) at
epoch 1 with its AdamW moments and the schedule's step, and logs the
schedule's learning rate (1e-12 against the port's schedule, 4 fp32 ulps
against optax's); ``--loadckpt`` of the same file gives the weights of
``params_from_jax`` of its ``params``, bit for bit, and of a
reference-style bare ``.ckpt`` the npz's."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load_npz
from effi_mvs_plus_tpu.train import trainer as JT
from effi_mvs_plus_tpu.train.optim import make_optimizer as jax_optimizer
from effi_mvs_plus_tpu_torch.cli import train as cli
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint, params_from_jax
from effi_mvs_plus_tpu_torch.train import trainer as T
from effi_mvs_plus_tpu_torch.train.optim import onecycle_linear
from effi_mvs_plus_tpu_torch.utils import logging as tlog
from test_torch_cli_train import _build_tiny_dtu_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "checkpoints", "model_dtu.npz")
LR, STEPS, EPOCHS = 1e-3, 3, 2
TOTAL = STEPS * EPOCHS + 100          # the CLI's schedule length



@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    return root, _build_tiny_dtu_tree(root)


@pytest.fixture(scope="module")
def jax_logdir(tmp_path_factory):
    """A logdir holding the JAX payload of epoch 0: 3 optax updates with
    seeded gradients from the shipped weights, on the schedule the CLI
    builds for 2 epochs of 3 steps."""
    logdir = tmp_path_factory.mktemp("jax_logdir")
    params = jax.tree.map(jnp.asarray, jax_load_npz(NPZ))
    tx, sched = jax_optimizer(LR, TOTAL, params=params)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    state = jax.jit(tx.init)(params)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        grads = jax.tree_util.tree_map_with_path(
            lambda p, x: (np.zeros(x.shape, np.float32)
                          if p[-1].key in ("running_mean", "running_var")
                          else (rng.standard_normal(x.shape) * 1e-2)
                          .astype(np.float32)), params)
        params, state = update(grads, state, params)
    path = os.path.join(str(logdir), "model_000000.ckpt")
    JT.save_checkpoint(path, jax.device_get(params), jax.device_get(state),
                       0)
    return str(logdir), path, jax.tree.map(np.asarray, params), sched


def _argv(root, listfile, logdir):
    return ["--mode", "train", "--device", "cpu", "--trainpath", root,
            "--trainlist", listfile, "--testlist", listfile,
            "--logdir", logdir, "--crop_wh", "96,64", "--batch_size", "7",
            "--trainviews", "3", "--testviews", "3", "--num_workers", "2",
            "--summary_freq", "1", "--lr", str(LR)]


def test_resume_continues_a_jax_run(tree, jax_logdir, monkeypatch, capsys):
    monkeypatch.setattr(tlog.MetricsWriter, "__init__",
                        functools.partialmethod(tlog.MetricsWriter.__init__,
                                                tensorboard=False))
    root, listfile = tree
    logdir, path, params, jax_sched = jax_logdir
    cli.main(_argv(root, listfile, logdir)
             + ["--epochs", str(EPOCHS), "--resume"])
    assert f"resuming {path} at epoch 1" in capsys.readouterr().out
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    assert any(r.get("event") == "resume" and r["epoch"] == 1 for r in rows)
    train = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train] == [4, 5, 6]
    sched = onecycle_linear(LR, TOTAL)
    for r in train:
        assert abs(r["train/lr"] - sched(r["step"])) <= 1e-12
        want = float(jax_sched(r["step"]))
        assert abs(r["train/lr"] - want) <= 2.0 ** -21 * want   # 4 ulps
        assert np.isfinite(r["train/loss"])

    # the port's checkpoint of epoch 1 is now the newest: 3 JAX steps and
    # 3 of the port's in its AdamW steps and its schedule
    newest = T.latest_checkpoint(logdir)
    assert newest.endswith("model_000001.ckpt")
    after = T.load_checkpoint(newest)
    assert after["epoch"] == 1
    assert {float(s["step"]) for s in after["optimizer"]["state"].values()} \
        == {6.0}
    assert after["scheduler"]["last_epoch"] == 6
    start = params_from_jax(params)
    moved = max(float((after["model"][k] - start[k]).abs().max())
                for k in start if k.endswith("weight"))
    assert 0 < moved <= 3 * LR * 1.01, moved


def test_loadckpt_takes_the_weights_of_every_format(tree, jax_logdir,
                                                    tmp_path):
    """``--loadckpt`` of the JAX payload: the weights of
    ``params_from_jax(params)``; of a reference-style bare ``.ckpt``
    (``torch.save`` of the state dict alone): the npz's.  Weights only:
    no optimizer state, epoch 0."""
    root, listfile = tree
    _, path, params, _ = jax_logdir
    bare = str(tmp_path / "reference.ckpt")
    torch.save(load_npz_checkpoint(NPZ), bare)
    for ckpt, want in ((path, params_from_jax(params)),
                       (bare, load_npz_checkpoint(NPZ))):
        args = cli.build_parser().parse_args(
            _argv(root, listfile, str(tmp_path)) + ["--loadckpt", ckpt])
        model, payload, start = cli.load_model(args, cli.make_config(args),
                                               torch.device("cpu"))
        assert payload is None and start == 0
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (ckpt, k)
