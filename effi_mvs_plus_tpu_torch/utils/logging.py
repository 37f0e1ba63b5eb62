"""Scalar metrics sink: append-only JSONL, one object per row, plus
TensorBoard events when ``torch.utils.tensorboard`` can be imported.

The port's copy of ``effi_mvs_plus_tpu/utils/logging.py::MetricsWriter``.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """Scalar metrics sink: JSONL always, TensorBoard when available."""

    def __init__(self, logdir: str, tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(logdir, "tb"))
            except Exception:
                self._tb = None

    def scalars(self, step: int, values: dict, prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}"
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._f.write(json.dumps(rec) + "\n")

    def event(self, name: str, **fields):
        """Append a non-scalar lifecycle row (e.g. a resume) so run
        history is reconstructable from the JSONL alone."""
        rec = {"event": name, "time": time.time()}
        for k, v in fields.items():
            rec[k] = v if isinstance(v, (str, bool)) else float(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
