"""Checkpoints in the JAX train CLI's pickle layout, written without JAX or
optax (``chip_smoke.py`` writes one with their imports refused).

``effi_mvs_plus_tpu/train/trainer.py`` ``save_checkpoint`` pickles
``{"params": tree, "opt_state": state, "epoch": int}``: the parameter tree
in the JAX package's layouts (HWIO, DHWIO, transpose convolutions flipped)
and the optax state of its ``make_optimizer``,
``MaskedState(inner_state=(ScaleByAdamState(count, mu, nu), EmptyState(),
ScaleByScheduleState(count)))`` with ``MaskedNode`` at the BN running
statistics, counts as 0-d int32 arrays, dict keys sorted as JAX rebuilds
them.  ``write_jax_checkpoint`` writes that layout from the port's
stand-in classes (``io/jax_checkpoint.py``) under the optax names a real
file carries; ``tests/test_torch_checkpoint.py`` holds its file to load
exactly as one that JAX wrote.

Imports numpy and the port only.
"""

import pickle

import numpy as np

from effi_mvs_plus_tpu_torch.io import jax_checkpoint as jc

_OPTAX_NAMES = {cls: where for where, cls in jc.OPTAX_CLASSES.items()}
_STATE_LEAVES = ("running_mean", "running_var")
# the JAX package's import rules (effi_mvs_plus_tpu/io/torch_import.py)
_TRANSPOSE_CONVS = {
    ("cost_regularization", "conv6"), ("cost_regularization", "conv7"),
    ("CSP_R1", "conv2"), ("CSP_R2", "conv2"),
    ("CSP_C1", "conv2"), ("CSP_C2", "conv2"),
}
_ALIAS_PREFIXES = ("update_block.", "CSP_R.", "CSP_C.", "GetCost",
                   "depthnet")


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, naming the stand-ins by their optax
    module and class as a file that optax wrote does."""

    def save_global(self, obj, name=None):
        if obj not in _OPTAX_NAMES:
            return super().save_global(obj, name)
        module, qualname = _OPTAX_NAMES[obj]
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _split_path(key):
    parts = key.split(".")
    top = parts[0]
    if top in ("feature", "cnet_depth"):
        if len(parts) > 2 and parts[1].startswith("conv") \
                and parts[2].isdigit():
            return [top, f"{parts[1]}.{parts[2]}"] + parts[3:]
        return [top, parts[1]] + parts[2:]
    if top.startswith("update_block_depth"):
        if parts[1] == "mask":
            return [top, f"mask.{parts[2]}"] + parts[3:]
        return [top, parts[1], parts[2]] + parts[3:]
    return [top, parts[1]] + parts[2:]


def _relayout(path, arr):
    if path[-1] != "weight" or arr.ndim < 4:
        return arr
    if arr.ndim == 4:
        return np.transpose(arr, (2, 3, 1, 0))
    if (path[0], path[1]) in _TRANSPOSE_CONVS:
        return np.transpose(arr, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1].copy()
    return np.transpose(arr, (2, 3, 4, 1, 0))


def _sorted(tree):
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


def jax_tree_from_state_dict(sd):
    """A reference state dict ({name: tensor or array}) -> the JAX
    package's parameter tree (``import_state_dict``'s rules), float32."""
    tree = {}
    for key, v in sd.items():
        if key.endswith("num_batches_tracked") \
                or key.startswith(_ALIAS_PREFIXES):
            continue
        path = _split_path(key)
        arr = np.asarray(v.numpy() if hasattr(v, "numpy") else v,
                         dtype=np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_relayout(path, arr))
    return _sorted(tree)


def seeded_moments(params, steps, seed, scale=1e-3):
    """AdamW's (mu, nu) after ``steps`` updates from gradients drawn
    N(0, scale^2) from ``seed``: trees like ``params`` with ``MaskedNode``
    at the BN running statistics, float32."""
    rng = np.random.default_rng(seed)

    def rec(tree, key=None):
        if isinstance(tree, dict):
            pairs = {k: rec(v, k) for k, v in tree.items()}
            return ({k: m for k, (m, _) in pairs.items()},
                    {k: n for k, (_, n) in pairs.items()})
        if key in _STATE_LEAVES:
            return jc.MaskedNode(), jc.MaskedNode()
        mu = np.zeros(tree.shape, np.float32)
        nu = np.zeros(tree.shape, np.float32)
        for _ in range(steps):
            g = (rng.standard_normal(tree.shape) * scale).astype(np.float32)
            mu = np.float32(0.9) * mu + np.float32(0.1) * g
            nu = np.float32(0.999) * nu + np.float32(0.001) * g * g
        return mu, nu
    return rec(params)


def write_jax_checkpoint(path, params, mu, nu, adam_count, sched_count,
                         epoch):
    """Pickle ``{"params", "opt_state", "epoch"}`` in the JAX train CLI's
    layout (see the module docstring)."""
    state = jc.MaskedState(inner_state=(
        jc.ScaleByAdamState(count=np.asarray(adam_count, np.int32),
                            mu=mu, nu=nu),
        jc.EmptyState(),
        jc.ScaleByScheduleState(count=np.asarray(sched_count, np.int32))))
    with open(path, "wb") as f:
        _Pickler(f, pickle.DEFAULT_PROTOCOL).dump(
            {"params": params, "opt_state": state, "epoch": int(epoch)})
