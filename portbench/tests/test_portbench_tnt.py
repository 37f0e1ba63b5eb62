"""The Tanks & Temples cell: the frozen reference against the port's plain
CPU path at a tiny T&T shape (11 views, 96/8/8), the kernels' work at the
cell's shapes against counts done by hand, the cell and its
configuration found by name and listed in every metric it reports, the
rest of a run, driven on the CPU at a tiny size, correct until the timed
path underneath is broken, and the confidence's planted faults and (on
the card, at the cell's own size) the TF32 control failing its limits."""

import json
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from portbench import run
from portbench.lib import compare, counts, registry, scene
from portbench.reference import model as ref_model
from portbench.reference import weights as ref_weights

from effi_mvs_plus_tpu_torch.io import load_state_dict
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model

CELL, CONFIG = "tnt_eval_fp32-b2", "tnt_eval_fp32"
CKPT = registry.ROOT / "checkpoints" / "model_tank.npz"
CPU = torch.device("cpu")
SERVE_METRICS = ["engine.upload_ms.serve", "model.conv_ms.serve",
                 "model.other_ms.serve", "k1.roofline.serve",
                 "k2.roofline.serve", "k4.roofline.serve", "mfu.serve",
                 "device.idle.serve"]


def _random_npz(dest, seed):
    """The T&T checkpoint's arrays under their own names (aliases alike),
    each replaced by seeded normal values of its own mean and spread; BN's
    running variances kept positive."""
    out = {}
    with np.load(CKPT) as data:
        for k in data.files:
            a = data[k]
            if not np.issubdtype(a.dtype, np.floating):
                out[k] = a
                continue
            rng = np.random.default_rng(
                [seed, zlib.crc32(ref_weights.canonical(k).encode())])
            r = a.mean() + a.std() * rng.standard_normal(a.shape)
            if k.endswith("running_var"):
                r = np.abs(r) + 1e-3
            out[k] = r.astype(a.dtype)
    np.savez(dest, **out)
    return dest


def _tiny_tnt():
    """The T&T configuration at 64x96 with its 11 views and 96/8/8."""
    cfg = registry.config(CONFIG)
    H, W = 64, 96
    fx, fy, cx, cy = cfg["scene"]["intrinsics"]
    sx, sy = W / cfg["input"]["width"], H / cfg["input"]["height"]
    cfg["input"] = dict(cfg["input"], height=H, width=W)
    cfg["scene"] = dict(cfg["scene"], intrinsics=[fx * sx, fy * sx,
                                                  cx * sx, cy * sy],
                        texture_size=64)
    return cfg


@pytest.mark.parametrize("weights", ["model_tank", "seeded_random"])
def test_forward_matches_the_port_at_a_tiny_tnt_shape(tmp_path, weights):
    cfg = _tiny_tnt()
    ckpt = CKPT if weights == "model_tank" else _random_npz(
        tmp_path / "random.npz", 2 ** 31 + 41)
    inp = cfg["input"]
    assert inp["views"] == 11 and cfg["model"]["ndepths"] == [96, 8, 8]
    batch = scene.render_batch(cfg["scene"], 2, inp["views"], inp["height"],
                               inp["width"], 2 ** 31 + 43, 0, CPU)
    b = {k: ({s: torch.from_numpy(v) for s, v in x.items()}
             if isinstance(x, dict) else torch.from_numpy(x))
         for k, x in batch.items()}
    model = build_model(load_state_dict(str(ckpt)),
                        EffiMVSConfig(ndepths=(96, 8, 8)), CPU)
    with torch.no_grad():
        out = model(b["imgs"], b["proj_matrices"], b["depth_values"])
        counter = ref_model.Counter()
        preds, conf = ref_model.Reference(
            ref_weights.to_device(ref_weights.load_npz(ckpt), CPU),
            cfg["model"], counter=counter).forward(**b)
    assert len(preds) == 13
    for a, r in zip(out["depth"], preds):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-3)
    torch.testing.assert_close(out["photometric_confidence"], conf,
                               rtol=0, atol=1e-5)
    assert [(w["stage"], w["depth"].shape[1]) for w in counter.warps] == \
        [(0, 96), (1, 8), (2, 8)]
    assert all(w["rot"].shape[:2] == (2, 10) for w in counter.warps)


def test_kernel_work_at_the_cell_shapes_by_hand():
    # K1, stage 1: B=2, V=10 sources, D=96 hypotheses (one vector a row),
    # 132x240 (1056x1920 / 8), C=32, bf16; every source texel tapped.
    # outputs 2*10*96*132*240 = 60,825,600; per output 10*32 + 16 = 336
    # operations; bytes (2*31,680*32 reference + 633,600*32 texels +
    # 60,825,600 outputs) * 2 + 2*96*4 depths + 2*10*12*4 projections
    b, f = counts.k1_work(2, 10, 96, 132, 240, 32, 2 * 10 * 132 * 240,
                          "bfloat16", False)
    assert f == 20_437_401_600
    assert b == 166_256_640 + 768 + 960
    # stage 3: 528x960, C=8, 8 hypotheses a pixel
    # outputs 2*10*8*506,880 = 81,100,800; operations 81,100,800 * 96
    b, f = counts.k1_work(2, 10, 8, 528, 960, 8, 0, "bfloat16", True)
    assert f == 7_785_676_800
    assert b == (2 * 506_880 * 8 + 81_100_800) * 2 + 2 * 8 * 506_880 * 4 \
        + 960
    # K4: the feature net's 4 levels on B*V = 22 images, the context
    # net's on 2; the first layer's of each 3 -> c -> c
    model = registry.config(CONFIG)["model"]
    k4 = counts.k4_launches(model, 2, 11, 1056, 1920, "bfloat16")
    assert len(k4) == 8
    # feature level 0: 22*2,027,520 = 44,605,440 pixels, 3 -> 8 -> 8:
    # 18 * (24 + 64) = 1,584 operations a pixel; reads 3 and writes 8
    # channels of bf16, weights (9*24 + 8 + 9*64 + 8) fp32
    assert k4[0] == (44_605_440 * 11 * 2 + 808 * 4, 70_655_016_960)
    # feature level 3: 22*132*240 = 696,960 pixels, 64 -> 64 -> 64
    assert k4[3] == (696_960 * 128 * 2 + (2 * (9 * 4096 + 64)) * 4,
                     696_960 * 18 * 8192)
    # context level 0: 2*2,027,520 = 4,055,040 pixels, 3 -> 4 -> 4
    assert k4[4] == (4_055_040 * 7 * 2 + (9 * 12 + 4 + 9 * 16 + 4) * 4,
                     4_055_040 * 18 * 28)
    # K2: 3 iterations a stage, 9 a forward
    assert len(counts.k2_launches(model, 2, 1056, 1920, "bfloat16")) == 9


def test_the_cell_is_found_and_listed(bench):
    wl = registry.workload(CELL)
    cfg = registry.config(CONFIG)
    entry = {c["name"]: c for c in bench["configs"]}[CONFIG]
    assert entry["file"] == f"portbench/configs/{CONFIG}.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == \
        cfg["reduced"] == []
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
        == (wl["config"], wl["traffic"], wl["chips"], wl["why"])
    assert wl["kind"] == "serve_closed_fp32" and wl["params"]["batch"] == 2
    assert cfg["model"]["compute_dtype"] == "float32"
    assert (registry.ROOT / cfg["checkpoint"]).is_file()
    dtu = registry.config("dtu_eval")["model"]
    assert {k: v for k, v in cfg["model"].items()
            if k not in ("ndepths", "compute_dtype")} == \
        {k: v for k, v in dtu.items() if k not in ("ndepths", "compute_dtype")}
    assert cfg["model"]["ndepths"] == [96, 8, 8]
    assert (cfg["input"]["height"], cfg["input"]["width"],
            cfg["input"]["views"]) == (1056, 1920, 11)
    assert len(scene.rig(cfg["scene"], 11)) == 11
    assert registry.cell_metrics(bench, CELL, "end_to_end") == [
        "maps_per_s", "batch_p90_ms", "peak_mem_gib", "setup_s"]
    assert registry.cell_metrics(bench, CELL, "per_layer") == SERVE_METRICS
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in SERVE_METRICS + ["maps_per_s", "batch_p90_ms"]:
            assert CELL in m["workloads"], m["name"]
    json.dumps(wl, allow_nan=False)


def _run(tiny, bench, trace=False):
    return run.run_cell(CELL, 2 ** 31 + 47, 0.5, trace, CPU, bench_dir=tiny,
                        bench=bench)


def test_a_sound_run_is_correct(tiny, bench):
    res = _run(tiny, bench)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(
        registry.cell_metrics(bench, CELL, "end_to_end"))


def _altered_answer(monkeypatch):
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    orig = InferenceEngine.infer_batch

    def infer_batch(self, batch):
        depth, conf = orig(self, batch)
        depth[-1] *= 1.01                   # one map's depths, 1% off
        return depth, conf
    monkeypatch.setattr(InferenceEngine, "infer_batch", infer_batch)


def _half_the_batch_served(monkeypatch):
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    orig = InferenceEngine.infer_batch

    def infer_batch(self, batch):
        half = {k: v[:1] for k, v in batch.items() if k != "proj_matrices"}
        half["proj_matrices"] = {k: v[:1] for k, v in
                                 batch["proj_matrices"].items()}
        depth, conf = orig(self, half)
        n = batch["imgs"].shape[0]
        return np.repeat(depth, n, 0), np.repeat(conf, n, 0)
    monkeypatch.setattr(InferenceEngine, "infer_batch", infer_batch)


@pytest.mark.parametrize("fault", [_altered_answer, _half_the_batch_served])
def test_a_broken_timed_path_is_not_correct(tiny, bench, fault,
                                            monkeypatch):
    fault(monkeypatch)
    res = _run(tiny, bench)
    assert not res["correct"], res["checks"]


def _readings(bench_dir, device, seed, **params):
    wl = registry.workload(CELL, bench_dir)
    wl["params"] = dict(wl["params"], **params)
    kind = registry.traffic(wl["kind"], bench_dir)
    return wl, kind.calibrate(run.Context(
        wl, registry.config(CONFIG, bench_dir), seed, device), {})


def test_the_confidence_faults_fail_the_limits(tiny):
    """On the CPU the control (TF32) computes what the reference does, so
    only the program and the planted faults are read here."""
    wl, r = _readings(tiny, CPU, 2 ** 31 + 53)
    assert compare.judge(r["program"], wl["limits"])[0], r
    assert compare.judge(r["control"], wl["limits"])[0], r
    for fault, numbers in r["faults"].items():
        assert not compare.judge(numbers, wl["limits"])[0], (fault, r)


def test_an_fp32_kind_refuses_a_bf16_configuration(tiny):
    wl = registry.workload(CELL, tiny)
    cfg = registry.config(CONFIG, tiny)
    cfg["model"]["compute_dtype"] = "bfloat16"
    kind = registry.traffic(wl["kind"], tiny)
    with pytest.raises(ValueError, match="fp32"):
        kind.calibrate(run.Context(wl, cfg, 1, CPU), {})


CARD_READINGS = """
import json, sys, torch
sys.path.insert(0, ".")
from portbench import run
from portbench.lib import registry
wl = registry.workload("%s")
wl["params"] = dict(wl["params"], pool=1, sample=1)
r = registry.traffic(wl["kind"]).calibrate(run.Context(
    wl, registry.config(wl["config"]), 2 ** 31 + 59, torch.device("cuda")),
    {})
print(json.dumps([wl["limits"], r]))
""" % CELL


@pytest.mark.cuda
def test_the_tf32_control_fails_the_limits_at_the_cell_size():
    """At the cell's own size (one pool batch of 2 maps, to hold a test
    run): the program passes, the TF32 control and each planted fault
    fail.  In a process of its own: card tests run before it in this one
    can leave torch's TF32 switches in a state in which reading them
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32)")
    p = subprocess.run([sys.executable, "-c", CARD_READINGS],
                       cwd=registry.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    limits, r = json.loads(p.stdout.strip().splitlines()[-1])
    assert compare.judge(r["program"], limits)[0], r
    assert not compare.judge(r["control"], limits)[0], r
    for fault, numbers in r["faults"].items():
        assert not compare.judge(numbers, limits)[0], (fault, r)
