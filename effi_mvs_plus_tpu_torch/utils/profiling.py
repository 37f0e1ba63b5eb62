"""Timing and tracing: a fenced wall-clock ``Timer`` and ``profile_trace``.

The port's copy of ``effi_mvs_plus_tpu/utils/profiling.py``.  On a CUDA
device the fence is ``torch.cuda.synchronize`` and the step times come
from CUDA events; on the CPU every call has finished when it returns, so
there is nothing to fence.  ``profile_trace`` records a
``torch.profiler`` trace (CPU and, on the card, CUDA activity) and writes
it as a chrome trace under its directory.
"""

from __future__ import annotations

import contextlib
import os
import time

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
    """Trace the block with ``torch.profiler`` and write
    ``<logdir>/trace.json`` (chrome trace format, for Perfetto or
    chrome://tracing); CUDA activity too on a CUDA ``device`` (the
    default).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        fence(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
