"""The traced window reduced to what the per-layer metrics read.

A traced run records two steady stretches with ``torch.profiler``.  The
first, of ``trace_units`` batches or steps, records CUDA activity only,
so no operator on the host is instrumented: its device activity
(kernels, copies, sets), classified by kernel name with the frozen
``CLASSES``, and its length on the host clock (from before the first
call to after the device is synchronised) give every metric and the
device's busy and idle time.  The second, a few units inside one
``bench.window`` span, records CPU activity too: only to name the
longest idle gaps of the breakdown by the benchmark's own span open
(``bench.next_batch``, ``engine.infer_batch`` or ``trainer.step``,
``bench.sample``, ``bench.readback``); its per-operator instrumentation
lengthens those gaps.  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.lib.counts import PEAK_FLOPS, bound_s

# kernel-name markers of each class, tested in this order (a frozen copy
# of the port's profile scripts' classes)
CLASSES = (
    ("k3_warp_correlate_bwd", ("warp_correlate_bwd_kernel",
                               "dref_sum_kernel")),
    ("k1_warp_correlate", ("warp_correlate_kernel",
                           "warp_correlate_direct_kernel")),
    ("k2_conv_gru", ("conv_gru_kernel",)),
    ("k4_conv_chain", ("conv_chain_kernel",)),
    ("memcpy_memset", ("Memcpy", "Memset")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm",
                     "winograd", "fprop", "cutlass", "sm90_", "sm80_")),
)
WINDOW = "bench.window"
SPANS = ("bench.next_batch", "engine.infer_batch", "trainer.step",
         "bench.sample", "bench.readback")


def classify(name):
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def union(intervals):
    """[(start, end)] merged, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(device, spans, window_s, n=10):
    """The ``n`` longest stretches of [0, window_s] in which ``device``
    [(name, class, start, end)] runs nothing, longest first, each named by
    the innermost span of ``spans`` [(name, start, end)] open at its
    middle ('none' where none is): [[name, seconds]]."""
    busy = union([(s, e) for _, _, s, e in device])
    edges = [0.0] + [x for iv in busy for x in iv] + [window_s]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]

    def open_at(t):
        best = None
        for name, s, e in spans:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "none"
    return [[open_at((a + b) / 2), b - a] for a, b in gaps]


@dataclasses.dataclass
class Trace:
    """What the readers see: the measured stretch's device activity
    [(name, class, start, end)] in seconds, its length on the host clock,
    how many units (batches or steps) it holds, and the cell's work counts
    (``work``: per unit); ``gaps``: the instrumented stretch's longest
    idle gaps, named."""
    device: list
    window_s: float
    units: int
    work: dict
    gaps: list = dataclasses.field(default_factory=list)

    def busy_s(self):
        return sum(e - s for s, e in union([(a, b) for _, _, a, b in
                                            self.device]))

    def class_s(self, cls):
        """Device seconds of a class, per unit."""
        return sum(e - s for _, c, s, e in self.device if c == cls) \
            / self.units

    def memcpy_s(self, marker):
        """Seconds per unit of the copies whose name holds ``marker``."""
        return sum(e - s for n, _, s, e in self.device
                   if n.startswith("Memcpy") and marker in n) / self.units

    def breakdown(self, n=10):
        by_name = {}
        for name, _, s, e in self.device:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": self.gaps[:n]}


def device_activity(prof, t0=None, t1=None):
    """[(name, class, start, end)] of a finished profile's device
    activity in seconds from ``t0`` (profiler microseconds; the first
    device event's start by default), clipped to [t0, t1]."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == cuda
              and e.name not in SPANS and e.name != WINDOW]
    if t0 is None and events:
        t0 = min(s for _, s, _ in events)
    out = []
    for name, s, e in events:
        s, e = max(s, t0), e if t1 is None else min(e, t1)
        if e > s:
            out.append((name, classify(name), (s - t0) / 1e6,
                        (e - t0) / 1e6))
    if not out:
        raise RuntimeError("the profiler recorded no device activity")
    return out


def named_gaps(prof, n=10):
    """A finished profile of CPU and CUDA activity holding one
    ``bench.window`` span -> its device's longest idle gaps, named by the
    benchmark span open (``idle_gaps``)."""
    events = prof.events()
    windows = [e for e in events if e.name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"{len(windows)} '{WINDOW}' spans in the trace")
    t0, t1 = windows[0].time_range.start, windows[0].time_range.end
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.name, (max(e.time_range.start, t0) - t0) / 1e6,
              (min(e.time_range.end, t1) - t0) / 1e6) for e in events
             if e.name in SPANS and e.device_type != cuda]
    return idle_gaps(device_activity(prof, t0, t1), spans,
                     (t1 - t0) / 1e6, n)


def roofline_pct(trace, cls, key):
    """100 x the least time of a unit's launches of a kernel class
    (``trace.work[key]``: [(bytes, flops, dtype)]) over their measured
    device time a unit; None where the class did not run or no work is
    counted."""
    launches = trace.work.get(key)
    t = trace.class_s(cls)
    if not launches or t <= 0:
        return None
    return 100.0 * sum(bound_s(b, f, d) for b, f, d in launches) / t


def mfu_pct(trace):
    """100 x the model's FLOPs a unit times the units over the window's
    length, over the dtype's peak."""
    flops = trace.work.get("model_flops")
    if not flops:
        return None
    return 100.0 * flops * trace.units / trace.window_s \
        / PEAK_FLOPS[trace.work["dtype"]]
