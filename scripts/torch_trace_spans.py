#!/usr/bin/env python3
"""The benchmark's traced stretch read through the program's own spans.

    python3 scripts/torch_trace_spans.py [--cells dtu_eval-b6,dtu_train-b4]
        [--seeds 1000003,2000003] [--rounds 2] [--out FILE]

Needs one CUDA GPU and nvcc; imports nothing of JAX.  First loads the
kernel library (``_kernels.build_seconds``: the nvcc seconds of a
checkout's first run), then, for each cell and seed,
sets up the benchmark's own session (``portbench/``: the cell's
configuration, traffic and rendered pool) and, after 2 warm-up units,
runs ``rounds`` x (off, on, on, off) stretches of the cell's
``trace_units`` units, each as ``portbench/run.py``'s measured stretch
(``torch.profiler`` with CUDA activity only, its length on the host
clock from before the first call to after a synchronise), with the
tracer on (``utils/profiling.tracing``) and a marker kernel launched
at the end (``portbench/lib/spans.py``) in the "on" stretches.  Prints
one JSON line a cell and seed: the stretches' ms a unit by mode (the
tracing-on cost), and from each "on" stretch the per-unit readings that
spans and counters give (device ms by span, the upload's GB/s, its
share staged through the engine's pinned ring and the ring's slot fills
a unit, the device's idle ms by innermost span, idle inside
``train.step``, counters), beside the benchmark's own readers of the
same stretch (busy, idle, copies, upload ms) for the checks between
them.  Last, the host cost of a span with tracing off and on.  ``--out``
also writes the lines to a file.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STRETCH = ("off", "on", "on", "off")


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def stretch(sess, units, on, device):
    """One measured stretch as portbench/run.py's: (window s, profiler,
    recording or None, t0_ns, t1_ns, the marker's time or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from effi_mvs_plus_tpu_torch.utils import profiling
    from portbench.lib import spans
    marker_ns = None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.tracing() if on else contextlib.nullcontext() \
                as rec:
            t0_ns = time.perf_counter_ns()
            for _ in range(units):
                sess.step()
            torch.cuda.synchronize(device)
            t1_ns = time.perf_counter_ns()
        if on:
            marker_ns = spans.mark()
            torch.cuda.synchronize(device)
    return (t1_ns - t0_ns) / 1e9, prof, rec, t0_ns, t1_ns, marker_ns


def readings(prof, rec, marker_ns, window_s, units, t0_ns, t1_ns, serve):
    """Per-unit readings of one "on" stretch, spans beside the
    benchmark's own readers."""
    from portbench.lib import spans
    from portbench.lib import trace as tr
    t = tr.Trace(tr.device_activity(prof), window_s, units, {})
    span_names = sorted({s.name for s in rec.spans})
    out = {"units": units, "spans": len(rec.spans), "dropped": rec.dropped,
           "span_units": rec.units(),
           "window_ms": 1e3 * window_s / units,
           "busy_ms": 1e3 * t.busy_s() / units,
           "idle_ms": 1e3 * (window_s - t.busy_s()) / units,
           "copies_ms": 1e3 * t.class_s("memcpy_memset"),
           "htod_ms": 1e3 * t.memcpy_s("HtoD"),
           "device_names_equal_to_spans": sorted(
               {n for n, _, _, _ in t.device if n in span_names}),
           "counters": {k: v / units for k, v in rec.counters.items()},
           "device_ms": {n: rec.device_ms(n) / units for n in span_names
                         if rec.device_ms(n) is not None},
           "host_ms": {n: rec.host_ns(n) / 1e6 / units
                       for n in span_names}}
    busy = spans.device_intervals(prof, rec, marker_ns)
    out["marker_shift_ms"] = marker_shift_ms(prof, rec, marker_ns)
    idle = spans.idle_by_span(busy, rec.spans, t0_ns, t1_ns)
    out["idle_by_span_ms"] = {str(k): v / 1e6 / units
                              for k, v in sorted(idle.items(),
                                                 key=lambda kv: -kv[1])}
    out["idle_check_ms"] = sum(idle.values()) / 1e6 / units
    dm = out["device_ms"]
    if serve:
        up = rec.counters.get("engine.upload_bytes", 0)
        up_ns = rec.host_ns("engine.upload")
        out["engine.upload_gbps.serve"] = up / up_ns if up_ns else None
        # the share of the upload's bytes that went through the engine's
        # pinned ring (1.0 for every CUDA batch), and its slot fills
        staged = rec.counters.get("engine.upload_staged_bytes", 0)
        out["engine.upload_staged_share"] = staged / up if up else None
        out["engine.upload_chunks"] = rec.counters.get(
            "engine.upload_chunks", 0) / units
        for n in ("features",) + tuple(f"stage{s}" for s in (1, 2, 3)):
            out[f"model.{n}_ms.serve"] = dm.get(f"model.{n}")
        parts = sum(dm.get(f"model.{n}", 0) for n in
                    ("features", "stage1", "stage2", "stage3"))
        lo = out["busy_ms"] - out["copies_ms"]
        out["check_stages_within"] = [lo, parts, lo + out["idle_ms"]]
        out["check_upload_gbps_vs_ms"] = (
            up / units / 1e6 / out["htod_ms"] if out["htod_ms"] else None)
    else:
        for n in ("forward", "backward", "optimizer"):
            out[f"step.{n}_ms.train"] = dm.get(f"train.{n}")
        steps = [s for s in rec.spans if s.name == "train.step"]
        inside = spans.idle_by_span(busy, steps, t0_ns, t1_ns)
        out["step.dispatch_idle_ms.train"] = \
            inside.get("train.step", 0) / 1e6 / units
        parts = sum(dm.get(f"train.{n}", 0) for n in
                    ("forward", "backward", "optimizer"))
        out["check_step_within"] = [out["busy_ms"] - out["htod_ms"], parts,
                                    out["window_ms"]]
        out["check_dispatch_idle_at_most"] = [
            out["step.dispatch_idle_ms.train"], out["idle_ms"]]
    return out


def marker_shift_ms(prof, rec, marker_ns):
    """The shift (ms) that ``device_intervals`` applies: the host's time
    before the marker's launch less the launch call's start mapped through
    the wall-clock anchor alone; None where the profiler missed it."""
    import torch

    from portbench.lib import spans
    wall0, mono0 = rec.anchor
    base = prof.profiler.kineto_results.trace_start_ns() - wall0 + mono0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    marks = {e.id for e in events if e.device_type == cuda
             and spans.MARKER in e.name}
    calls = [base + round(e.time_range.start * 1e3) for e in events
             if e.device_type != cuda and e.id in marks
             and "Launch" in e.name]
    if not calls or marker_ns is None:
        return None
    return (marker_ns - min(calls, key=lambda t: abs(t - marker_ns))) / 1e6


def run_cell(cell, seed, rounds, device):
    import torch

    import portbench.run as pr
    from portbench.lib import registry
    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    kind = registry.traffic(wl["kind"])
    sess = kind.Session(pr.Context(wl, cfg, seed, device))
    units = wl["params"]["trace_units"]
    for _ in range(2):
        sess.step()
    sess.begin_window()
    per_mode = {"off": [], "on": []}
    on_readings = []
    for r in range(rounds):
        for mode in STRETCH:
            window_s, prof, rec, t0, t1, marker_ns = stretch(
                sess, units, mode == "on", device)
            per_mode[mode].append(1e3 * window_s / units)
            if mode == "on" and len(on_readings) < 2:
                on_readings.append(readings(
                    prof, rec, marker_ns, window_s, units, t0, t1,
                    wl["kind"] == "serve_closed"))
            del prof, rec
    failed = sess.failed
    sess.release()
    del sess
    torch.cuda.empty_cache()
    off, on = (statistics.median(per_mode[m]) for m in ("off", "on"))
    return {"cell": cell, "seed": seed, "failed": failed,
            "stretch_ms_a_unit": per_mode,
            "tracing_on_cost_pct": 100.0 * (on - off) / off,
            "on_stretches": on_readings}


def span_cost_ns(device):
    """Host ns of one ``with span(...)`` with tracing off, and on (a host
    span, and one with device events, taken from the pool)."""
    from effi_mvs_plus_tpu_torch.utils import profiling
    n = 200_000

    def loop(dev, k):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with profiling.span("probe.cost", dev):
                pass
        return (time.perf_counter_ns() - t0) / k
    off = min(loop(device, n) for _ in range(3))
    with profiling.tracing():
        host = loop(None, 20_000)
    for _ in range(2):          # the second block finds its events pooled
        with profiling.tracing() as rec:
            dev = loop(device, 20_000)
        rec.spans               # reading the spans gives their events back
    return {"off": off, "on_host": host, "on_device": dev}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="dtu_eval-b6,dtu_train-b4")
    ap.add_argument("--seeds", default="1000003,2000003")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from effi_mvs_plus_tpu_torch.ops import _kernels
    _kernels.library()
    lines = [{"card": _card(), "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "kernels.build_s": _kernels.build_seconds()}]
    print(json.dumps(lines[0]), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        for cell in args.cells.split(","):
            lines.append(run_cell(cell, seed, args.rounds, device))
            print(json.dumps(lines[-1]), flush=True)
    lines.append({"span_cost_ns": span_cost_ns(device)})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
