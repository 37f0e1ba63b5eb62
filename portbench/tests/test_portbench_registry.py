"""The harness finds every part by its name, refuses an unknown one, and
picks up a cell, a configuration and a metric added as files alone; and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest
import torch

from portbench.lib import registry
from portbench.lib import trace as tr

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_named_part_is_found(bench):
    for c in bench["configs"]:
        assert registry.config(c["name"])
        assert (registry.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"]
        kind = registry.traffic(wl["kind"])
        assert isinstance(wl["params"], dict)
        assert hasattr(kind, "Session") and hasattr(kind, "calibrate")
        assert set(wl["limits"])
    for m in bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


@pytest.mark.parametrize("kind,name", [
    ("workloads", "no_such_cell"), ("configs", "no_such_config"),
    ("traffic", "no_such_kind"), ("metrics", "no.such.metric"),
    ("traffic", "serve_b6"),
    ("workloads", "../configs/dtu_eval")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises(registry.Unknown):
        if kind in ("traffic", "metrics"):      # a mix names no generator
            registry._module(kind, name, registry.HERE)
        else:
            registry.load_json(kind, name)


def test_parts_added_as_files_are_found(tmp_path, bench):
    root = tmp_path / "bench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "dtu_eval.json").read_text())
    cfg["model"]["compute_dtype"] = "float32"
    (root / "configs" / "dtu_eval_fp32.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "dtu_eval-b6.json").read_text())
    cell["config"] = "dtu_eval_fp32"
    (root / "workloads" / "dtu_eval_fp32-b6.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "k4.launch_ms.serve.py").write_text(
        "def read(t):\n    return t.class_s('k4_conv_chain') * 1e3 or None\n")
    wl = registry.workload("dtu_eval_fp32-b6", root)
    assert registry.config(wl["config"], root)["model"]["compute_dtype"] \
        == "float32"
    t = tr.Trace([("conv_chain_kernel<1>", "k4_conv_chain", 0.0, 0.002)],
                 0.01, 2, {})
    assert registry.metric("k4.launch_ms.serve", root).read(t) == 1.0
    added = dict(bench)
    added["workloads"] = bench["workloads"] + [
        {"name": "dtu_eval_fp32-b6", "config": "dtu_eval_fp32",
         "traffic": "serve_b6", "chips": 1, "why": "x"}]
    added["end_to_end"] = [dict(m, workloads=m["workloads"]
                                + ["dtu_eval_fp32-b6"])
                           if "dtu_eval-b6" in m.get("workloads", []) else m
                           for m in bench["end_to_end"]]
    added["per_layer"] = bench["per_layer"] + [
        {"name": "k4.launch_ms.serve", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": bench["per_layer"][8]["layer"],
         "moves": "maps_per_s", "workloads": ["dtu_eval_fp32-b6"]}]
    assert "k4.launch_ms.serve" in registry.cell_metrics(
        added, "dtu_eval_fp32-b6", "per_layer")
    assert "maps_per_s" in registry.cell_metrics(
        added, "dtu_eval_fp32-b6", "end_to_end")
    assert "k4.launch_ms.serve" not in registry.cell_metrics(
        added, "dtu_eval-b6", "per_layer")


def test_cells_report_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        e2e = registry.cell_metrics(bench, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.cell_metrics(bench, w["name"], "per_layer")


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in bench["end_to_end"] + bench[
        "per_layer"])) == len(bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert UNIT.match(m["unit"]) and m["layer"] in layers
    assert len(json.dumps(bench)) < 64 * 1024


def test_the_trace_reduction_names_and_counts():
    device = [("conv_gru_kernel", "k2_conv_gru", 0.0, 0.004),
              ("Memcpy HtoD (Pageable -> Device)", "memcpy_memset",
               0.004, 0.006),
              ("void elementwise_kernel", "other", 0.008, 0.010)]
    gaps = tr.idle_gaps(device, [("engine.infer_batch", 0.0, 0.0099),
                                 ("bench.sample", 0.0099, 0.02)], 0.02)
    t = tr.Trace(device, 0.02, 2,
                 {"k2": [(3.35e12 * 0.001, 0.0, "float32")],
                  "model_flops": 67e12 * 0.001, "dtype": "float32"}, gaps)
    assert tr.classify("warp_correlate_direct_kernel") == "k1_warp_correlate"
    assert tr.classify("dref_sum_kernel") == "k3_warp_correlate_bwd"
    assert tr.classify("sm90_xmma_fprop") == "convolution"
    assert t.busy_s() == pytest.approx(0.008)
    assert registry.metric("device.idle.serve").read(t) == pytest.approx(60)
    assert registry.metric("engine.upload_ms.serve").read(t) == \
        pytest.approx(1.0)
    assert registry.metric("model.other_ms.serve").read(t) == \
        pytest.approx(1.0)
    assert registry.metric("model.conv_ms.serve").read(t) is None
    # a unit's K2 work bounds at 1 ms against 2 ms measured a unit
    assert registry.metric("k2.roofline.serve").read(t) == pytest.approx(50)
    assert registry.metric("k1.roofline.serve").read(t) is None
    assert registry.metric("mfu.serve").read(t) == pytest.approx(10)
    assert gaps[0] == ["bench.sample", pytest.approx(0.01)]
    assert [g[0] for g in gaps[1:]] == ["engine.infer_batch"]
    assert t.breakdown()["idle_gaps"] == gaps


def test_the_profiler_reduction_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            with record_function("engine.infer_batch"):
                torch.ones(4) + 1
    with pytest.raises(RuntimeError, match="no device activity"):
        tr.device_activity(prof)
    with pytest.raises(RuntimeError, match="no device activity"):
        tr.named_gaps(prof)
