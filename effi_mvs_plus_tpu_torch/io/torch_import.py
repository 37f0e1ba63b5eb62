"""Checkpoint loading for the port.

* ``load_npz_checkpoint(path)`` — the shipped ``checkpoints/*.npz`` hold
  the reference's raw torch state dict (563 keys, PyTorch layouts), so the
  port's modules take it as it is: no relayout.  The ModuleList aliases
  (``update_block.N``, ``CSP_R.N``, ``CSP_C.N``) are aliases in the port's
  module tree too (``models/effi_mvs.py``), so a strict load sees neither
  missing nor unexpected keys.
* ``load_state_dict(path)`` — the weights an entry point's ``--loadckpt``
  names: a shipped ``.npz`` or a port checkpoint.
* ``params_from_jax(tree)`` — the JAX package's parameter pytree (numpy
  arrays, its XLA layouts) back to the same state dict: HWIO -> OIHW,
  DHWIO -> OIDHW, and the transpose convolutions, which the JAX package
  keeps spatially flipped as (kd,kh,kw,I,O), un-flipped to (I,O,kd,kh,kw).
"""

from __future__ import annotations

import numpy as np
import torch

# canonical transpose-convolution parameter sites (JAX tree paths)
_TRANSPOSE_CONVS = {
    ("cost_regularization", "conv6"),
    ("cost_regularization", "conv7"),
    ("CSP_R1", "conv2"), ("CSP_R2", "conv2"),
    ("CSP_C1", "conv2"), ("CSP_C2", "conv2"),
}

# ModuleList alias prefix -> canonical prefix, as the reference registers
# the same modules twice
ALIASES = {
    "update_block.0.": "update_block_depth1.",
    "update_block.1.": "update_block_depth2.",
    "update_block.2.": "update_block_depth3.",
    "CSP_R.0.": "CSP_R1.", "CSP_R.1.": "CSP_R2.",
    "CSP_C.0.": "CSP_C1.", "CSP_C.1.": "CSP_C2.",
}


def load_npz_checkpoint(path) -> dict:
    """Read a shipped ``.npz`` state dict -> {name: CPU tensor}."""
    with np.load(path) as data:
        return {k: torch.from_numpy(np.array(data[k])) for k in data.files}


def load_state_dict(path) -> dict:
    """Network weights from a shipped ``.npz`` or from a torch checkpoint
    whose ``"model"`` entry is the state dict (the port's
    ``model_NNNNNN.ckpt``)."""
    if str(path).endswith(".npz"):
        return load_npz_checkpoint(path)
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


def _unrelayout(path, arr):
    if path[-1] != "weight" or arr.ndim < 4:
        return arr
    if arr.ndim == 4:                                   # (kh,kw,I,O)
        return np.transpose(arr, (3, 2, 0, 1))
    if (path[0], path[1]) in _TRANSPOSE_CONVS:          # flipped (kd,kh,kw,I,O)
        return np.transpose(arr[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))
    return np.transpose(arr, (4, 3, 0, 1, 2))           # (kd,kh,kw,I,O)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> dict:
    """JAX parameter pytree -> the port's full state dict (aliases and
    ``num_batches_tracked`` included, so it loads strictly)."""
    sd = {}
    for path, arr in _flatten(tree):
        w = _unrelayout(path, np.asarray(arr, dtype=np.float32))
        sd[".".join(path)] = torch.from_numpy(np.ascontiguousarray(w))
        if path[-1] == "running_var":
            sd[".".join(path[:-1] + ("num_batches_tracked",))] = \
                torch.zeros((), dtype=torch.long)
    for alias, canon in ALIASES.items():
        for k in list(sd):
            if k.startswith(canon):
                sd[alias + k[len(canon):]] = sd[k]
    return sd
