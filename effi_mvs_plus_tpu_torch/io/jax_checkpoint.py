"""The checkpoint files of the JAX package, read without JAX, optax or
orbax.

The JAX train CLI writes ``model_NNNNNN.ckpt`` as a raw pickle
(``effi_mvs_plus_tpu/train/trainer.py`` ``save_checkpoint``):
``{"params": tree, "opt_state": optax state, "epoch": int}``, every array
a numpy array in the JAX package's layouts.  The port names its own
checkpoints the same way but writes them with ``torch.save`` (a zip), and
the shipped weights are an ``.npz`` (a zip too), so ``checkpoint_format``
tells the files apart by their content, not their names:

* ``"npz"`` — a zip of ``.npy`` members: the shipped state dict;
* ``"torch"`` — a ``torch.save`` file, zip or legacy: the port's payload
  or a reference ``.ckpt``;
* ``"jax"`` — any other pickle stream (first byte 0x80): the JAX CLI's
  payload, read by ``read_jax_checkpoint``;
* a directory is an orbax checkpoint, which only the JAX package's
  library API writes (``save_checkpoint`` of a path without ``.ckpt``).
  The port refuses it with its reason: reading one needs orbax.

``read_jax_checkpoint`` unpickles with a closed list of globals: numpy's
array and dtype reconstructors (under ``numpy._core`` as numpy 2 writes
them or ``numpy.core`` as numpy 1 does, taken from whichever the
installed numpy has) and the optax state classes, which it maps to the
plain stand-ins below (same fields, same order).  Any other global
raises ``pickle.UnpicklingError`` naming it: nothing else is imported or
called.
"""

from __future__ import annotations

import importlib
import os
import pickle
from typing import Any, NamedTuple

import numpy as np


class MaskedState(NamedTuple):
    inner_state: Any


class MaskedNode(NamedTuple):
    """A leaf that ``optax.masked`` keeps out of the optimizer (the BN
    running statistics)."""


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class EmptyState(NamedTuple):
    pass


# the optax classes a JAX checkpoint names (optax 0.2.6) -> stand-ins
OPTAX_CLASSES = {
    ("optax.transforms._masking", "MaskedState"): MaskedState,
    ("optax.transforms._masking", "MaskedNode"): MaskedNode,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
    ("optax._src.base", "EmptyState"): EmptyState,
}

_NUMPY_CORE = ("numpy._core" if int(np.__version__.split(".")[0]) >= 2
               else "numpy.core")
# numpy's array reconstructors (module under numpy._core / numpy.core,
# name): pickle protocol 4, Python's default up to 3.13, and protocol 5
_NUMPY_FUNCS = {("multiarray", "_reconstruct"), ("numeric", "_frombuffer")}
_NUMPY_TYPES = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}

# legacy (non-zip) torch.save files open with torch's magic number
_TORCH_LEGACY = b"\x80\x02\x8a\nl\xfc\x9cF\xf9 j\xa8P\x19"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in OPTAX_CLASSES:
            return OPTAX_CLASSES[module, name]
        if (module, name) in _NUMPY_TYPES:
            return _NUMPY_TYPES[module, name]
        for core in ("numpy._core.", "numpy.core."):
            if module.startswith(core) \
                    and (module[len(core):], name) in _NUMPY_FUNCS:
                mod = importlib.import_module(
                    f"{_NUMPY_CORE}.{module[len(core):]}")
                return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"a JAX checkpoint holds numpy arrays and optax states; this "
            f"one names the global {module}.{name}, which is not read")


def checkpoint_format(path) -> str:
    """``"npz"``, ``"torch"`` or ``"jax"``, from the content of ``path``;
    ValueError, with the reason, for an orbax directory or anything
    else."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory (the JAX package's "
            f"save_checkpoint to a path without .ckpt); reading it needs "
            f"the orbax package, which the port does not use.  Write the "
            f"run's checkpoints as model_NNNNNN.ckpt pickles, as the JAX "
            f"train CLI does")
    with open(path, "rb") as f:
        head = f.read(len(_TORCH_LEGACY))
    if head.startswith(b"PK\x03\x04"):
        import zipfile
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if names and all(n.endswith(".npy") for n in names):
            return "npz"
        if any(n.endswith("data.pkl") for n in names):
            return "torch"
    elif head.startswith(_TORCH_LEGACY):
        return "torch"
    elif head[:1] == b"\x80":
        return "jax"
    raise ValueError(f"{path}: neither a .npz, a torch.save file, a JAX "
                     f"checkpoint pickle nor an orbax directory")


def read_jax_checkpoint(path) -> dict:
    """The JAX train CLI's payload: ``params`` (the JAX parameter tree),
    ``opt_state`` (the optax state in the stand-ins above, ``MaskedNode``
    at the BN running statistics) and ``epoch`` (an int)."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if not (isinstance(payload, dict) and "params" in payload):
        raise ValueError(f"{path}: not a JAX checkpoint payload (no "
                         f"'params')")
    payload["epoch"] = int(payload.get("epoch", 0))
    return payload
