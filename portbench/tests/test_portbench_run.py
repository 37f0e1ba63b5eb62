"""A run without a card fails and prints no result; the rest of a run,
driven on the CPU at a tiny size, comes out correct, and false once the
timed path underneath is broken by each fault the cell can have."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run
from portbench.lib import registry

CPU = torch.device("cpu")


def _cli(args, cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _cli(["--workload", "dtu_eval-b6", "--seed", "2147483650",
              "--seconds", "1", "--trace", "0"], registry.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_unknown_cell_no_result():
    p = _cli(["--workload", "no_such_cell", "--seed", "1", "--seconds",
              "1", "--trace", "0"], registry.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; sys.path.insert(0, '.');"
         "import portbench.run as r;"
         "print(r.run_cell('dtu_eval-b6', 1, 1, False,"
         " torch.device('cpu')))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "effi_mvs_plus_tpu_torch" in p.stderr


def _run(tiny, bench, cell, trace=False):
    return run.run_cell(cell, 2 ** 31 + 11, 0.5, trace, CPU, bench_dir=tiny,
                        bench=bench)


@pytest.mark.parametrize("cell", ["dtu_eval-b6", "dtu_train-b4"])
def test_a_sound_run_is_correct(tiny, bench, cell):
    res = _run(tiny, bench, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == set(
        registry.cell_metrics(bench, cell, "end_to_end"))
    json.dumps(res, allow_nan=False)


def _altered_answer(monkeypatch):
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    orig = InferenceEngine.infer_batch

    def infer_batch(self, batch):
        depth, conf = orig(self, batch)
        depth[0] *= 1.01                     # one map's depths, 1% off
        return depth, conf
    monkeypatch.setattr(InferenceEngine, "infer_batch", infer_batch)


def _half_the_batch_served(monkeypatch):
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    orig = InferenceEngine.infer_batch

    def infer_batch(self, batch):
        half = {k: (v if k == "proj_matrices" else v[:1]) for k, v in
                batch.items()}
        half["proj_matrices"] = {k: v[:1] for k, v in
                                 batch["proj_matrices"].items()}
        depth, conf = orig(self, half)
        n = batch["imgs"].shape[0]
        return np.repeat(depth, n, 0), np.repeat(conf, n, 0)
    monkeypatch.setattr(InferenceEngine, "infer_batch", infer_batch)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_the_batch_trained(monkeypatch):
    from effi_mvs_plus_tpu_torch.train import trainer
    orig = trainer.batch_to_device

    def batch_to_device(batch, device):
        out = orig(batch, device)
        if not (isinstance(batch, dict) and "imgs" in batch):
            return out                  # the original's recursion

        def half(t):
            if isinstance(t, dict):
                return {k: half(v) for k, v in t.items()}
            return t[:t.shape[0] // 2]
        return half(out)
    monkeypatch.setattr(trainer, "batch_to_device", batch_to_device)


def _altered_loss(monkeypatch):
    from effi_mvs_plus_tpu_torch.train import trainer
    orig = trainer.make_train_step

    def make_train_step(*a, **k):
        step = orig(*a, **k)

        def altered(batch):
            m = step(batch)
            m["loss"] = m["loss"] * 1.5         # a wrong answer
            return m
        return altered
    monkeypatch.setattr(trainer, "make_train_step", make_train_step)


@pytest.mark.parametrize("cell,fault", [
    ("dtu_eval-b6", _altered_answer),
    ("dtu_eval-b6", _half_the_batch_served),
    ("dtu_train-b4", _state_unchanged),
    ("dtu_train-b4", _half_the_batch_trained),
    ("dtu_train-b4", _altered_loss),
])
def test_a_broken_timed_path_is_not_correct(tiny, bench, cell, fault,
                                            monkeypatch):
    fault(monkeypatch)
    res = _run(tiny, bench, cell)
    assert not res["correct"], res["checks"]


def test_a_run_that_loads_jax_prints_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "effi_mvs_plus_tpu_torch_x", object())
    assert run.forbidden_modules() == []
