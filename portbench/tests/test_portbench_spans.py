"""``lib/spans.py``, the program's spans against a profiler's device
activity: the attribution of idle time to spans and the mapping of
Kineto's stamps onto the spans' clock on synthetic events; on the card
(marked ``cuda``, skipped without a GPU) a planted sleep put down to its
span, and the tracer's launch counters a unit against the benchmark's
launch lists (``lib/counts.py``) for its two cells, at a small image."""

import json
import time
from types import SimpleNamespace as NS

import pytest
import torch

from portbench.lib import spans
from portbench.lib.registry import ROOT

H, W = 256, 320                 # a small image of each cell's rig
STAGES = ("model.stage1", "model.stage2", "model.stage3")


def _sp(name, start, end):
    return NS(name=name, start_ns=start, end_ns=end)


@pytest.mark.parametrize("case", ["boundary", "nested", "outside"])
def test_idle_is_put_down_to_the_innermost_span(case):
    if case == "boundary":
        # idle [10, 20) exactly spans "a"; [30, 40) starts where "b" ends
        busy = [(0, 10), (20, 30), (40, 50)]
        opened = [_sp("a", 10, 20), _sp("b", 25, 30)]
        want = {"a": 10, None: 10}
    elif case == "nested":
        # "inner" [12, 16) inside "outer" [5, 45); idle [10, 20), [30, 40)
        busy = [(0, 10), (20, 30), (40, 50)]
        opened = [_sp("outer", 5, 45), _sp("inner", 12, 16)]
        want = {"outer": 16, "inner": 4}
    else:
        # overlapping busy intervals merge; idle before, between, after
        busy = [(5, 15), (10, 20), (30, 35)]
        opened = [_sp("s", 25, 28)]
        want = {None: 5 + 7 + 15, "s": 3}
    assert spans.idle_by_span(busy, opened, 0, 50) == want
    total = sum(spans.idle_by_span(busy, [], 0, 50).values())
    assert total == sum(want.values())


@pytest.mark.parametrize("marker", [True, False])
def test_device_intervals_map_kineto_stamps_onto_the_span_clock(marker):
    """Kineto's stamps (microseconds from its trace's start, on Unix-epoch
    nanoseconds) through the recording's anchor; shifted so that the
    marker's launch call starts at ``marker_ns``, where the profiler has
    it; the marker, host events and the spans' own device ranges left
    out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, start_us, end_us, corr=0):
        return NS(name=name, device_type=dev, id=corr,
                  time_range=NS(start=start_us, end=end_us))
    events = [ev("kernel_a", cuda, 10.0, 12.5),
              ev("cudaLaunchKernel", cpu, 13.0, 14.0, corr=7),
              ev("test.span", cuda, 9.0, 20.0),
              ev("memcpy", cuda, 15.0, 16.0),
              ev("at::cuda::spin_kernel(long)", cuda, 18.0, 18.001, corr=7)]
    prof = NS(events=lambda: events, profiler=NS(kineto_results=NS(
        trace_start_ns=lambda: 5_000_000)))
    # wall 4e6 ns is span clock 100
    rec = NS(anchor=(4_000_000, 100), spans=[_sp("test.span", 0, 1)])
    base = 5_000_000 - 4_000_000 + 100
    shift, marker_ns = 0, None
    if marker:
        marker_ns = base + 13_000 + 40      # the call started 40 ns later
        shift = 40
    assert spans.device_intervals(prof, rec, marker_ns) == [
        (base + 10_000 + shift, base + 12_500 + shift),
        (base + 15_000 + shift, base + 16_000 + shift)]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_planted_sleep_is_put_down_to_its_span(gpu):
    """A 5 ms sleep in a span between two kernels, under a profiler of CUDA
    activity: the device's idle gap between them is that span's.  The
    host opens the span only after the first kernel has ended and
    launches the second only after the span has closed, so on a right
    clock the gap holds the span: an edge may cross into the span by the
    clocks' error, 0.2 ms at most.  Outside the span the gap holds the
    host's own latency under the profiler (seeing the first kernel end,
    waking, launching the second), 0.1-0.6 ms on the card: 1 ms at
    most."""
    from torch.profiler import ProfilerActivity, profile

    from effi_mvs_plus_tpu_torch.utils.profiling import span, tracing
    x = torch.randn(1 << 20, device=gpu)
    done = torch.cuda.Event()
    for _ in range(2):                  # the second profile is measured
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                tracing() as rec:
            # a profiler's first CUDA calls set up its buffers on the
            # host (milliseconds): a first kernel takes that
            x.add_(0)
            y = x * 2
            done.record()
            while not done.query():
                pass
            with span("test.sleep"):
                time.sleep(0.005)
            z = y + 1
            marker_ns = spans.mark()
            torch.cuda.synchronize()
    del z
    busy = spans.device_intervals(prof, rec, marker_ns)
    (sleep,) = rec.spans
    gap = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])
           if s1 - e0 > 4_000_000]
    assert len(gap) == 1, (busy, sleep)
    (before, after), = gap
    assert -200_000 < sleep.start_ns - before < 1_000_000, (gap, sleep)
    assert -200_000 < after - sleep.end_ns < 1_000_000, (gap, sleep)
    idle = spans.idle_by_span(busy, rec.spans, busy[0][0], busy[-1][1])
    assert idle["test.sleep"] > sleep.end_ns - sleep.start_ns - 400_000, \
        idle


def _config(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _model_cfg(m):
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    return EffiMVSConfig(ndepths=tuple(m["ndepths"]),
                         gru_iters=tuple(m["gru_iters"]),
                         CostNum=m["cost_num"],
                         compute_dtype=getattr(torch, m["compute_dtype"]))


def _batch(cfg, B, gpu, with_depth=False):
    from portbench.lib import scene
    return scene.render_batch(cfg["scene"], B, cfg["input"]["views"], H, W,
                              12345, 0, gpu, with_depth=with_depth)


@pytest.mark.cuda
def test_a_served_batch_launches_as_the_benchmark_counts(gpu):
    """``dtu_eval``'s model (bf16, frozen weights) on a batch of 2: the
    tracer's K1/K2/K4 launches a batch as ``lib/counts.py`` lists them."""
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.utils.profiling import tracing
    from portbench.lib import counts
    cfg = _config("dtu_eval")
    m, B = cfg["model"], 2
    engine = InferenceEngine(load_state_dict(str(ROOT / cfg["checkpoint"])),
                             _model_cfg(m), device=gpu)
    batch = _batch(cfg, B, gpu)
    engine.infer_batch(batch)                      # packs the frozen weights
    with tracing() as rec:
        engine.infer_batch(batch)
    dt, V = m["compute_dtype"], cfg["input"]["views"]
    assert rec.counters["k1.launches"] == len(STAGES)
    assert rec.counters["k2.launches"] == len(counts.k2_launches(
        m, B, H, W, dt))
    assert rec.counters["k4.launches"] == len(counts.k4_launches(
        m, B, V, H, W, dt))


@pytest.mark.cuda
def test_a_training_step_launches_as_the_benchmark_counts(gpu):
    """``dtu_train``'s step (fp32) on a batch of 1: the tracer's K1/K3/K2
    launches a step as ``lib/counts.py`` lists them, and no K4."""
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import build_model
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
    from effi_mvs_plus_tpu_torch.train.trainer import make_train_step
    from effi_mvs_plus_tpu_torch.utils.profiling import tracing
    from portbench.lib import counts
    cfg = _config("dtu_train")
    m, t, B = cfg["model"], cfg["train"], 1
    model = build_model(load_state_dict(str(ROOT / cfg["checkpoint"])),
                        _model_cfg(m), gpu)
    opt, sched, _ = make_optimizer(model, t["lr"], t["total_steps"],
                                   t["weight_decay"])
    step = make_train_step(model, opt, sched, t["loss_rate"], device=gpu)
    batch = _batch(cfg, B, gpu, with_depth=True)
    step(batch)
    with tracing() as rec:
        float(step(batch)["loss"])
    assert rec.counters["k2.launches"] == len(counts.k2_launches(
        m, B, H, W, m["compute_dtype"]))
    assert rec.counters["k1.launches"] == rec.counters["k3.launches"] \
        == len(STAGES)
    assert "k4.launches" not in rec.counters
