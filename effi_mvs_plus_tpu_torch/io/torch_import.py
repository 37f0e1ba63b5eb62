"""Checkpoint loading for the port.

* ``load_npz_checkpoint(path)`` — the shipped ``checkpoints/*.npz`` hold
  the reference's raw torch state dict (563 keys, PyTorch layouts), so the
  port's modules take it as it is: no relayout.  The ModuleList aliases
  (``update_block.N``, ``CSP_R.N``, ``CSP_C.N``) are aliases in the port's
  module tree too (``models/effi_mvs.py``), so a strict load sees neither
  missing nor unexpected keys.
* ``load_state_dict(path)`` — the weights an entry point's ``--loadckpt``
  names, from every file the two packages write or read, told apart by
  content (``jax_checkpoint.checkpoint_format``): a shipped ``.npz``, a
  ``torch.save`` file (the port's ``model_NNNNNN.ckpt`` or a reference
  ``.ckpt``: ``ck.get("model", ck)``, a bare state dict too), or the JAX
  train CLI's pickle (its ``params`` through ``params_from_jax``); an
  orbax directory is refused with its reason.
* ``load_torch_checkpoint(path)`` / ``save_npz(path_ckpt, path_npz)`` —
  the JAX package's functions of the same names for a torch ``.ckpt``.
  Its ``import_state_dict`` has no counterpart: the port keeps the torch
  layouts, so a reference state dict needs no relayout.
* ``params_from_jax(tree)`` — the JAX package's parameter pytree (numpy
  arrays, its XLA layouts) back to the same state dict: HWIO -> OIHW,
  DHWIO -> OIDHW, and the transpose convolutions, which the JAX package
  keeps spatially flipped as (kd,kh,kw,I,O), un-flipped to (I,O,kd,kh,kw).
  ``torch_leaves(tree)`` does the same for any tree of that shape (the
  AdamW moments), skipping the leaves that are not arrays (``MaskedNode``).
"""

from __future__ import annotations

import numpy as np
import torch

from effi_mvs_plus_tpu_torch.io import jax_checkpoint as jc

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


def complete_state_dict(sd) -> dict:
    """A reference state dict with ``num_batches_tracked`` beside every
    ``running_var`` and the ModuleList aliases, each filled in where it is
    missing, so that it loads strictly."""
    sd = dict(sd)
    for k in list(sd):
        if k.endswith(".running_var"):
            sd.setdefault(k[:-len("running_var")] + "num_batches_tracked",
                          torch.zeros((), dtype=torch.long))
    for alias, canon in ALIASES.items():
        for k in list(sd):
            if k.startswith(canon):
                sd.setdefault(alias + k[len(canon):], sd[k])
    return sd


def _torch_file(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(path) -> dict:
    """A torch ``.ckpt`` (the reference's ``{"model": state_dict}``, a bare
    state dict, or the port's payload) -> the port's strict state dict."""
    ck = _torch_file(path)
    return complete_state_dict(ck.get("model", ck))


def save_npz(path_ckpt, path_npz):
    """Convert a torch ``.ckpt`` to a torch-free ``.npz`` of its raw named
    tensors, as the JAX package's ``save_npz`` does."""
    ck = _torch_file(path_ckpt)
    sd = ck.get("model", ck)
    np.savez_compressed(path_npz, **{k: v.numpy() for k, v in sd.items()})


def load_state_dict(path) -> dict:
    """Network weights from any checkpoint file of either package (see
    the module docstring), as a strict state dict of CPU tensors."""
    kind = jc.checkpoint_format(path)
    if kind == "npz":
        return load_npz_checkpoint(path)
    if kind == "jax":
        return params_from_jax(jc.read_jax_checkpoint(path)["params"])
    return load_torch_checkpoint(path)


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


def torch_leaves(tree) -> dict:
    """A tree in the JAX parameter layout -> {torch name: CPU tensor} in
    the torch layouts, over its array leaves only."""
    out = {}
    for path, arr in _flatten(tree):
        if hasattr(arr, "shape"):
            w = _unrelayout(path, np.asarray(arr, dtype=np.float32))
            out[".".join(path)] = torch.from_numpy(np.array(w, order="C"))
    return out


def params_from_jax(tree) -> dict:
    """JAX parameter pytree -> the port's full state dict (aliases and
    ``num_batches_tracked`` included, so it loads strictly)."""
    return complete_state_dict(torch_leaves(tree))
