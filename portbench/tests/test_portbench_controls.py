"""Each cell's control (the reference one precision below what its
configuration states) comes out as not correct under the cell's limits,
at a size a test run holds: fp8 for the bf16 serving cells on the CPU;
TF32 for the fp32 training cell, on the card only (the CPU has no TF32).
The readings at the cells' own sizes, on the card, are in PERF.md."""

import pytest
import torch

from portbench import run
from portbench.lib import compare, controls, registry


def _readings(tiny, cell, device, seed):
    wl = registry.workload(cell, tiny)
    kind = registry.traffic(wl["kind"], tiny)
    ctx = run.Context(wl, registry.config(wl["config"], tiny), seed, device)
    return wl, kind.calibrate(ctx, {})


def test_fp8_rounds_to_the_format():
    x = torch.tensor([448.0, 1.0, 0.3, -2.5])
    q = controls.fp8(x)
    assert q[0] == 448.0 and q[1] == 1.0 and q[3] == -2.5
    assert q[2] != 0.3 and abs(float(q[2]) - 0.3) < 0.3 / 16


@pytest.mark.parametrize("cell", ["dtu_eval-b6"])
def test_the_fp8_control_fails_the_serving_limits(tiny, cell):
    wl, r = _readings(tiny, cell, torch.device("cpu"), 2 ** 31 + 21)
    assert compare.judge(r["program"], wl["limits"])[0], r
    assert not compare.judge(r["control"], wl["limits"])[0], r
    for fault, numbers in r["faults"].items():      # the confidence's
        assert not compare.judge(numbers, wl["limits"])[0], (fault, r)


@pytest.mark.cuda
def test_the_tf32_control_fails_the_training_limits(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32)")
    wl, r = _readings(tiny, "dtu_train-b4", torch.device("cuda"),
                      2 ** 31 + 23)
    assert compare.judge(r["program"], wl["limits"])[0], r
    assert not compare.judge(r["control"], wl["limits"])[0], r
    for fault, numbers in r["faults"].items():
        assert not compare.judge(numbers, wl["limits"])[0], (fault, r)


def _devices():
    return ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(device)


@pytest.mark.parametrize("device", _devices())
def test_the_reference_sets_its_own_precision(tiny, monkeypatch, device):
    """With TF32 switched on before the check, as a program might leave it,
    the reference still computes with it off, reads what it reads with it
    off (on the card: to within a tenth of what TF32 moves; its own runs
    differ in the last bits), and leaves the switches as it found them."""
    from portbench.lib import scene
    from portbench.reference import model as ref_model
    from portbench.reference import weights as ref_weights
    from portbench.traffic import serve_closed, train_closed
    dev = _need(device)
    seen = []
    conv = ref_model.Reference.conv

    def recording_conv(self, *a, **k):
        seen.append(controls.switches())
        return conv(self, *a, **k)
    monkeypatch.setattr(ref_model.Reference, "conv", recording_conv)

    serve = run.Context(registry.workload("dtu_eval-b6", tiny),
                        registry.config("dtu_eval", tiny), 7, dev)
    train = run.Context(registry.workload("dtu_train-b4", tiny),
                        registry.config("dtu_train", tiny), 7, dev)
    inp = serve.config["input"]
    batch = scene.render_batch(serve.config["scene"], 1, inp["views"],
                               inp["height"], inp["width"], 7, 0, dev)
    params = ref_weights.to_device(ref_weights.load_npz(
        serve.root / serve.config["checkpoint"]), dev)
    inp = train.config["input"]
    batches = [scene.render_batch(train.config["scene"], 2, inp["views"],
                                  inp["height"], inp["width"], 7, i, dev,
                                  with_depth=True) for i in range(3)]

    def readings():
        a = serve_closed.reference_answers(params, serve.config["model"],
                                           batch, dev)
        return a, train_closed.reference_steps(train, batches)

    with controls.precision(tf32=False):
        off = readings()
    seen.clear()
    with controls.precision(tf32=True):
        on = readings()
        assert controls.switches() == (True, True, "high")
        assert seen and set(seen) == {(False, False, "highest")}
        seen.clear()
        tf32 = train_closed.reference_steps(train, batches, tf32=True)
        assert seen and set(seen) == {(True, True, "high")}
    serving = compare.serving_numbers([(d1, c1, d0, c0) for (d0, c0), (
        d1, c1) in zip(off[0], on[0])])
    training = compare.training_numbers(on[1], off[1])[0]
    moved = compare.training_numbers(tf32, off[1])[0]
    if dev.type == "cpu":       # no TF32 here: the same arithmetic
        assert set(serving.values()) == {0.0}
        assert set(training.values()) == {0.0}
    else:
        limits = registry.workload("dtu_eval-b6", tiny)["limits"]
        assert all(serving[k] <= v / 10 for k, v in limits.items()), serving
        for k in ("loss_gap", "grad_norm_gap_median"):
            assert training[k] <= moved[k] / 10, (training, moved)


@pytest.mark.cuda
def test_a_program_in_tf32_is_not_correct(tiny, bench, monkeypatch):
    """A program that switches TF32 on for its fp32 training step, and
    leaves it on, is held to the reference in true fp32 and fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32)")
    from effi_mvs_plus_tpu_torch.train import trainer
    make = trainer.make_train_step

    def make_in_tf32(*a, **k):
        step = make(*a, **k)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return step
    monkeypatch.setattr(trainer, "make_train_step", make_in_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    res = run.run_cell("dtu_train-b4", 2 ** 31 + 29, 0.5, False,
                       torch.device("cuda"), bench_dir=tiny, bench=bench)
    assert torch.backends.cudnn.allow_tf32      # the program's switch held
    assert not res["correct"], res["checks"]
