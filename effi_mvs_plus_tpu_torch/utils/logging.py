"""Metrics and images for eyeballing: the port's copy of
``effi_mvs_plus_tpu/utils/logging.py``.

* ``MetricsWriter``   — append-only JSONL scalars, one object per row, plus
                        TensorBoard events when ``torch.utils.tensorboard``
                        can be imported.
* ``save_image_grid`` — named maps (depth, confidence, error) side by side
                        in one PNG, colourised by ``_colorize`` (PIL).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


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


def _colorize(x, mask=None, vmin=None, vmax=None):
    """(H, W) float -> (H, W, 3) uint8 on a four-stop gradient (navy, cyan,
    yellow, red) between the 2nd and 98th percentiles of the valid values
    (``mask`` > 0.5, else the finite ones) or ``vmin``/``vmax``; invalid
    pixels black."""
    x = np.asarray(x, np.float32)
    if mask is not None:
        valid = np.asarray(mask) > 0.5
    else:
        valid = np.isfinite(x)
    vals = x[valid] if valid.any() else np.zeros(1, np.float32)
    lo = np.percentile(vals, 2) if vmin is None else vmin
    hi = np.percentile(vals, 98) if vmax is None else vmax
    t = np.clip((x - lo) / max(hi - lo, 1e-9), 0, 1)
    stops = np.array([[0, 0, 128], [0, 255, 255], [255, 255, 0],
                      [255, 0, 0]], np.float32)
    idx = np.clip(t * 3, 0, 2.999)
    i0 = idx.astype(np.int32)
    frac = (idx - i0)[..., None]
    rgb = stops[i0] * (1 - frac) + stops[i0 + 1] * frac
    rgb[~valid] = 0
    return rgb.astype(np.uint8)


def save_image_grid(path, images: dict, mask=None):
    """Write named (H, W) maps side by side, colourised, 8 black columns
    after each, as one PNG at ``path``; returns the path."""
    from PIL import Image
    panels = [_colorize(v, mask) for v in images.values()]
    h = max(p.shape[0] for p in panels)
    padded = [np.pad(p, ((0, h - p.shape[0]), (0, 8), (0, 0)))
              for p in panels]
    grid = np.concatenate(padded, axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)
    return path
