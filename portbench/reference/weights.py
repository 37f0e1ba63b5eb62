"""The shipped ``.npz`` state dict read with numpy, under one name a
parameter: the ModuleList aliases of the state dict (``update_block.i``,
``CSP_R.i``, ``CSP_C.i``) fold onto ``update_block_depth{i+1}``,
``CSP_R{i+1}`` and ``CSP_C{i+1}``."""

from __future__ import annotations

import re

import numpy as np
import torch

_ALIASES = ((re.compile(r"^update_block\.(\d)\."), "update_block_depth{}."),
            (re.compile(r"^CSP_R\.(\d)\."), "CSP_R{}."),
            (re.compile(r"^CSP_C\.(\d)\."), "CSP_C{}."))


def canonical(name):
    for pat, repl in _ALIASES:
        m = pat.match(name)
        if m:
            return repl.format(int(m.group(1)) + 1) + name[m.end():]
    return name


def load_npz(path):
    """{canonical name: float32 numpy array}, BN's counters left out."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            if k.endswith("num_batches_tracked"):
                continue
            name = canonical(k)
            a = np.asarray(data[k], np.float32)
            if name in out and not np.array_equal(out[name], a):
                raise ValueError(f"{k} differs from {name}")
            out[name] = a
    return out


def is_parameter(name):
    return not name.endswith(("running_mean", "running_var"))


def to_device(arrays, device, trainable=False):
    """{name: tensor on device}; with ``trainable`` the parameters (not
    BN's running statistics) require grad."""
    return {k: torch.from_numpy(a).to(device).requires_grad_(
        trainable and is_parameter(k)) for k, a in arrays.items()}
