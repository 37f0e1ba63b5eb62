"""The program's spans against a profiler's device activity.

The port's tracer (``effi_mvs_plus_tpu_torch/utils/profiling.py``)
stamps its spans on ``time.perf_counter_ns`` and reads, when a tracing
block starts, one (``time.time_ns()``, ``time.perf_counter_ns()``) pair,
its ``anchor``.  Kineto stamps its events, the device's too, in
Unix-epoch nanoseconds on ``time.time_ns()``'s base, so the anchor maps
them onto the spans' clock.  On the card the anchor alone was seen up to
0.4 ms off, from one profiler session to the next, so a caller that maps
device intervals launches a marker kernel (``mark``: a
``torch.cuda._sleep`` of a few cycles) inside the profiled stretch, and
``device_intervals`` puts the start of the marker's launch call (CUPTI's
runtime record, stamped on the device's clock) at the host's time just
before the call.  ``idle_by_span`` then puts the device's idle time down
to the innermost span open over it.

Not read by any metric yet: the breakdown's gaps are still named by
``trace.named_gaps`` from the benchmark's own spans.
"""

from __future__ import annotations

import time

import torch

MARKER = "spin_kernel"      # the marker's kernel (torch.cuda._sleep)


def mark():
    """Launch the marker kernel on the current device; returns the span
    clock's time just before its launch call."""
    t = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return t


def device_intervals(prof, rec, marker_ns=None):
    """[(start_ns, end_ns)] of the device activity (kernels, copies, sets)
    that a finished ``torch.profiler`` recorded, on the span clock of the
    tracer's recording ``rec`` (its ``anchor`` and ``spans``), in order of
    start: Kineto's stamps (microseconds from its trace's start, itself in
    Unix-epoch nanoseconds) mapped through ``rec.anchor``, then shifted so
    that the launch call of the marker kernel nearest ``marker_ns``
    (``mark``'s time) starts there, where the profiler recorded both.  The
    marker and the spans' own ranges on the device (``record_function``
    under CPU activity) are left out."""
    wall0, mono0 = rec.anchor
    base = prof.profiler.kineto_results.trace_start_ns() - wall0 + mono0
    names = {s.name for s in rec.spans}
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    marks = {e.id for e in events if e.device_type == cuda
             and MARKER in e.name}
    calls = [base + round(e.time_range.start * 1e3) for e in events
             if e.device_type != cuda and e.id in marks
             and "Launch" in e.name]
    shift = 0
    if calls and marker_ns is not None:
        shift = marker_ns - min(calls, key=lambda t: abs(t - marker_ns))
    return sorted((base + shift + round(e.time_range.start * 1e3),
                   base + shift + round(e.time_range.end * 1e3))
                  for e in events if e.device_type == cuda
                  and e.name not in names and MARKER not in e.name)


def idle_by_span(busy, spans, t0, t1):
    """The time of [t0, t1) outside every ``busy`` interval [(start, end)],
    put down to the innermost of ``spans`` open over it (the one opened
    last; a span holds [start_ns, end_ns)): {name, or None outside every
    span: ns}.  An idle stretch is split at every span edge inside it."""
    idle, cur = [], t0
    for s, e in sorted(busy):
        if s > cur:
            idle.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        idle.append((cur, t1))
    idle = [(a, b) for a, b in idle if b > a]
    marks = sorted({t0, t1, *(x for iv in idle for x in iv),
                    *(x for s in spans for x in (s.start_ns, s.end_ns)
                      if t0 < x < t1)})
    order = sorted(enumerate(spans), key=lambda p: (p[1].start_ns, p[0]))
    out, gi, si, open_ = {}, 0, 0, []
    for a, b in zip(marks, marks[1:]):
        while si < len(order) and order[si][1].start_ns <= a:
            open_.append(order[si])
            si += 1
        open_ = [p for p in open_ if p[1].end_ns > a]
        while gi < len(idle) and idle[gi][1] <= a:
            gi += 1
        if gi == len(idle) or idle[gi][0] > a:
            continue                        # the device is busy here
        inner = max(open_, key=lambda p: (p[1].start_ns, p[0]), default=None)
        name = inner[1].name if inner else None
        out[name] = out.get(name, 0) + b - a
    return out
