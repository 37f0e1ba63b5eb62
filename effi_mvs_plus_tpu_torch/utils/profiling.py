"""Timing and tracing: a fenced wall-clock ``Timer``, ``profile_trace``, and
the program's own spans and counters.

The port's copy of ``effi_mvs_plus_tpu/utils/profiling.py``.  On a CUDA
device the fence is ``torch.cuda.synchronize`` and the step times come
from CUDA events; on the CPU every call has finished when it returns, so
there is nothing to fence.  ``profile_trace`` records a
``torch.profiler`` trace (CPU and, on the card, CUDA activity) with the
program's spans in it, and writes it as a chrome trace under its
directory.

Spans and counters.  ``span(name, device)`` marks a stretch of the
program where the work happens: the engine's batch (``engine.batch``)
and its upload, forward and readback; the train step (``train.step``)
and its upload, forward, backward and optimizer; the model's features,
its stages and each GRU iteration.  With tracing off, the default, it
returns one shared object that does nothing, after one test of a module
flag.  Inside ``tracing()`` each span is recorded: its name, the span it
was opened in, its unit (a span opened while no other is open in its
thread starts a unit: an engine batch, a train step) and its start and
end on ``time.perf_counter_ns``.  A span given a CUDA device also
records a pair of pooled CUDA events on that device's current stream,
read when the block's spans are first read, after the block, never
inside it.  While a ``torch.profiler`` records, each span is also a
``record_function`` range of its trace.  Counters (``count``) are
always on, plain integer adds by name: ``k1.launches`` to
``k4.launches`` (the kernel wrappers' launches, K3 the warp's
backward), ``conv_pack.packs`` (K2/K4 operands packed at call time),
``conv_wgrad.calls`` and ``conv_wgrad.patch_bytes`` (3-D weight
gradients through ``ops/conv_wgrad.py``'s split-K GEMM, and the bytes of
their patch matrices), ``conv3d_reg.launches`` (the fused 3-D layers of
``ops/cuda_conv3d.py``, 25 a served forward), ``engine.upload_bytes``.

A tracing block also reads one (``time.time_ns()``,
``time.perf_counter_ns()``) pair when it starts, its ``anchor``: Kineto
stamps its events, the device's too, in Unix-epoch nanoseconds on
``time.time_ns()``'s base, so a reader of a profiler's trace can put the
device's activity on the spans' clock.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch


def fence(device):
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Mean time of ``fn()`` over ``iters`` calls after ``warmup`` calls,
    in seconds, for work queued on ``device`` (cuda unless told
    otherwise).  On a CUDA device the interval is taken between two CUDA
    events around the timed calls; on the CPU by ``perf_counter``."""

    def __init__(self, fn, warmup=2, iters=10, device="cuda"):
        self.fn = fn
        self.warmup = warmup
        self.iters = iters
        self.device = torch.device(device)

    def measure(self, *args, **kwargs):
        for _ in range(self.warmup):
            self.fn(*args, **kwargs)
        fence(self.device)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.iters):
                self.fn(*args, **kwargs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / self.iters
        t0 = time.perf_counter()
        for _ in range(self.iters):
            self.fn(*args, **kwargs)
        return (time.perf_counter() - t0) / self.iters


@contextlib.contextmanager
def profile_trace(logdir, device="cuda"):
    """Trace the block with ``torch.profiler``, the program's spans
    included, and write ``<logdir>/trace.json`` (chrome trace format, for
    Perfetto or chrome://tracing); CUDA activity too on a CUDA ``device``
    (the default).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof, tracing():
        yield prof
        fence(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------- spans

CAPACITY = 1 << 16          # spans a tracing block keeps; later ones drop

_ON = False                 # the one test a span makes with tracing off
_depth = 0                  # tracing blocks open
_anchor = (0, 0)            # (time.time_ns(), perf_counter_ns()) at start
_records = []               # the spans of the open blocks, as opened
_dropped = 0
_unit = 0
_local = threading.local()  # each thread's stack of open spans
_event_pool = collections.defaultdict(list)   # device -> free CUDA events
_counters = collections.defaultdict(int)


class _Off:
    """What ``span`` returns with tracing off: one object, no work."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span(NamedTuple):
    """A finished span: ``parent`` is the name of the span it was opened
    in (None for a unit's root), ``unit`` its unit's number, ``start_ns``
    and ``end_ns`` are on ``time.perf_counter_ns``, ``device_ms`` the
    device time between its CUDA events (None for a host span)."""
    name: str
    parent: str | None
    unit: int
    start_ns: int
    end_ns: int
    device_ms: float | None


def _event(stream):
    pool = _event_pool[stream.device]
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


class _Record:
    __slots__ = ("name", "device", "parent", "unit", "start_ns", "end_ns",
                 "stream", "events", "device_ms", "annotation")

    def __init__(self, name, device):
        self.name, self.device = name, device
        self.end_ns = self.events = self.device_ms = self.annotation = None

    def __enter__(self):
        global _unit, _dropped
        stack = _local.__dict__.setdefault("stack", [])
        if stack:
            self.parent, self.unit = stack[-1].name, stack[-1].unit
        else:
            _unit += 1
            self.parent, self.unit = None, _unit
        stack.append(self)
        if len(_records) < CAPACITY:
            _records.append(self)
            if self.device is not None and self.device.type == "cuda":
                self.stream = torch.cuda.current_stream(self.device)
                self.events = (_event(self.stream), _event(self.stream))
                self.events[0].record(self.stream)
        else:
            _dropped += 1
        if torch.autograd.profiler._is_profiler_enabled:
            self.annotation = torch.autograd.profiler.record_function(
                self.name)
            self.annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        _local.stack.pop()
        return False

    def resolve(self):
        """The finished ``Span``; the device time is read (waiting for the
        end event) once, and the events go back to the pool."""
        if self.events is not None:
            self.events[1].synchronize()
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            _event_pool[self.stream.device].extend(self.events)
            self.events = None
        return Span(self.name, self.parent, self.unit, self.start_ns,
                    self.end_ns, self.device_ms)


def span(name, device=None):
    """A context that marks a stretch of the program as ``name``; with a
    CUDA ``device`` (a ``torch.device``) also the device's work queued
    inside it.  With tracing off: one shared object that does nothing."""
    if not _ON:
        return _OFF
    return _Record(name, device)


class Recording:
    """What a ``tracing()`` block recorded, filled when the block ends:
    ``spans`` [Span] in the order they were opened (spans still open at
    the end are left out; the device times are read, waiting for each
    span's end event, when ``spans`` is first read), ``counters`` {name:
    increase over the block}, ``anchor`` (``time.time_ns()``,
    ``time.perf_counter_ns()``) read together when tracing started,
    ``dropped`` spans past ``CAPACITY``."""

    def __init__(self):
        self.counters, self.anchor, self.dropped = {}, _anchor, 0
        self._records, self._spans = [], None

    @property
    def spans(self):
        if self._spans is None:
            self._spans = [r.resolve() for r in self._records]
            self._records = []
        return self._spans

    def units(self):
        """How many units the spans belong to."""
        return len({s.unit for s in self.spans})

    def device_ms(self, name):
        """Device ms of the spans named ``name``, summed (None where none
        of them timed the device)."""
        ms = [s.device_ms for s in self.spans
              if s.name == name and s.device_ms is not None]
        return sum(ms) if ms else None

    def host_ns(self, name):
        """Host ns of the spans named ``name``, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name == name)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block (tracing off again after it unless
    an outer block is open).  Yields a ``Recording`` of the block's
    spans, filled when the block ends."""
    global _ON, _depth, _anchor, _dropped
    if _depth == 0:
        _anchor = (time.time_ns(), time.perf_counter_ns())
        _dropped = 0
    rec = Recording()
    start, dropped, before = len(_records), _dropped, dict(_counters)
    _depth += 1
    _ON = True
    try:
        yield rec
    finally:
        _depth -= 1
        _ON = _depth > 0
        rec._records = [r for r in _records[start:] if r.end_ns is not None]
        if _depth == 0:
            _records.clear()
        rec.counters = {k: v - before.get(k, 0) for k, v in _counters.items()
                        if v != before.get(k, 0)}
        rec.dropped = _dropped - dropped


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (always on)."""
    _counters[name] += n


def counter(name):
    """The counter ``name``'s value in this process (0 before any add)."""
    return _counters.get(name, 0)
