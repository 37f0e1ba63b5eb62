#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process a run.  It finds a card (and fails without one: there is no
CPU fallback), builds the cell's traffic session from its files
(``workloads/<cell>.json`` with its traffic's kind and parameters,
``configs/<config>.json``, the generator ``traffic/<kind>.py``): the
port's entry with its kernels loaded from the checkout's build
directory, the checkpoint, inputs rendered from the seed, every shape of
the window warmed up; then runs the closed loop for
``--seconds`` (``--trace 1``: a profiled stretch of ``trace_units``
batches or steps instead, device activity only, read by
``metrics/<metric>.py``, and a short one with the host's activity that
names the breakdown's idle gaps), frees the
program, holds what the window produced to the plain reference, and
prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1``: ``breakdown`` too) and
``checks``, each number compared beside its limit, last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

_CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run inside the checkout, at fixed
# paths (the port's kernel library goes to build/cuda_kernels itself)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(_var, str(_CHECKOUT / "build" / "portbench" / _sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(_CHECKOUT))

FORBIDDEN = ("jax", "jaxlib", "flax", "effi_mvs_plus_tpu")
GIB = 2 ** 30
NAMED_UNITS = 3         # units of the traced run's instrumented stretch


def process_start():
    """The wall-clock time this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


class Context:
    """What a traffic session is given."""

    def __init__(self, workload, config, seed, device, root=_CHECKOUT):
        self.workload, self.config = workload, config
        self.params = workload["params"]
        self.seed, self.device, self.root = seed, device, Path(root)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else 1e308


def run_cell(cell, seed, seconds, trace, device, bench_dir=None,
             bench=None):
    """One run of a cell on ``device`` (the card; the tests pass the CPU)
    -> the result's dict.  ``bench_dir``: where the cell's files are
    (the benchmark's folder by default); ``bench``: BENCHMARK.json's
    content (read from the checkout by default)."""
    import torch
    from portbench.lib import compare, registry
    from portbench.lib import trace as tr

    bench_dir = Path(bench_dir or registry.HERE)
    bench = bench or registry.benchmark()
    wl = registry.workload(cell, bench_dir)
    cfg = registry.config(wl["config"], bench_dir)
    kind = registry.traffic(wl["kind"], bench_dir)
    ctx = Context(wl, cfg, seed, device)
    on_card = device.type == "cuda"

    sess = kind.Session(ctx)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - T_START

    breakdown = None
    if not trace:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            sess.step()
        elapsed = time.perf_counter() - t0
    else:
        from torch.profiler import ProfilerActivity, profile, record_function
        units = ctx.params["trace_units"]
        for _ in range(2):
            sess.step()
        sess.begin_window()
        # the measured stretch: device activity only, no host operator
        # instrumented; its length on the host clock
        cuda = [ProfilerActivity.CUDA] if on_card else []
        with profile(activities=cuda or [ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                sess.step()
            if on_card:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
        # a short instrumented stretch that names the idle gaps
        with profile(activities=[ProfilerActivity.CPU] + cuda) as named:
            with record_function(tr.WINDOW):
                for _ in range(min(units, NAMED_UNITS)):
                    sess.step()
                if on_card:
                    torch.cuda.synchronize(device)
        elapsed = None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e = {} if trace else sess.window_metrics(elapsed)
    attempted, failed = sess.attempted, sess.failed
    sess.release()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the run's process: {found}")

    numbers = sess.check(traced=bool(trace))
    correct, checks = compare.judge(numbers, wl["limits"])
    correct = correct and failed == 0 and attempted > 0

    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card
                   else "cpu", "count": wl["chips"],
                   "memory_peak_bytes": int(peak)}
    metrics = {}
    if not trace:
        e2e.update(setup_s=setup_s, peak_mem_gib=peak / GIB)
        unit_of = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name in registry.cell_metrics(bench, cell, "end_to_end"):
            if e2e.get(name) is not None:
                metrics[name] = {"value": e2e[name], "unit": unit_of[name]}
    else:
        t = tr.Trace(tr.device_activity(prof), window_s, units, sess.work,
                     tr.named_gaps(named)) if on_card else None
        unit_of = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name in registry.cell_metrics(bench, cell, "per_layer"):
            value = registry.metric(name, bench_dir).read(t) if t else None
            if value is not None:
                metrics[name] = {"value": value, "unit": unit_of[name]}
        if t is not None:
            device_info.update(busy_s=t.busy_s(), window_s=t.window_s)
            breakdown = t.breakdown()
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench.lib import registry
    try:
        chips = registry.workload(args.workload)["chips"]
    except registry.Unknown as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
