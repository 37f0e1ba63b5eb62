"""Checkpoints of the JAX package in the port, on the CPU, fp32.

The JAX package writes its train checkpoints with its own unchanged
``save_checkpoint``; the port reads them without JAX or optax
(``io/jax_checkpoint.py``), carries the AdamW state over
(``train/optim.load_optax_state``) and continues the run step for step:

* the optimizer: from the shipped DTU weights, 3 optax AdamW updates
  with seeded gradients, saved; a 4th update in JAX against the port's
  first step from the file (the same gradient, relaid out): every leaf of
  the 759,100 parameters and of both moments within 1e-6 of the leaf's
  largest magnitude against optax's update with its scalars in 64 bits
  (``jax.enable_x64``; every array stays fp32); against the plain fp32
  update the moments within 1e-6 and the parameters within 1e-5, as
  optax computes the bias correction ``1 - 0.999**4`` in fp32, 1.9e-5 of
  itself off, where torch's AdamW computes it in float64; the learning
  rate the schedule's at the carried count (1e-12 against the port's
  schedule, 4 fp32 ulps against optax's); no moment on a BN buffer;
* formats: the four files one ``load_state_dict`` takes (a JAX payload,
  a reference-style bare ``.ckpt``, a port checkpoint, the shipped
  ``.npz``) in a process that cannot import JAX, optax, orbax, flax or
  the JAX package; an orbax directory and a pickle with a foreign global
  refused with their reasons; ``save_npz`` against the JAX function,
  bitwise; ``latest_checkpoint`` over both packages' files;
* ``tests/jax_pickle.py`` (the layout ``chip_smoke.py`` writes without
  optax): its file loads exactly as the one JAX wrote.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load_npz
from effi_mvs_plus_tpu.io import torch_import as jax_io
from effi_mvs_plus_tpu.train import trainer as JT
from effi_mvs_plus_tpu.train.optim import make_optimizer as jax_optimizer
from effi_mvs_plus_tpu_torch.io import (checkpoint_format, jax_checkpoint,
                                        load_npz_checkpoint, load_state_dict,
                                        params_from_jax, save_npz,
                                        torch_leaves)
from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
from effi_mvs_plus_tpu_torch.train import trainer as T
from effi_mvs_plus_tpu_torch.train.optim import (load_optax_state,
                                                 make_optimizer)
import jax_pickle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "checkpoints", "model_dtu.npz")
LR, TOTAL = 1e-3, 40          # warm-up 2 steps: the 4th update anneals
N_PARAMS = 759_100



@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _grads(params, seed):
    """Seeded gradients for every trainable leaf, zero at the BN running
    statistics (optax.masked passes those through unchanged)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key in ("running_mean", "running_var"):
            return np.zeros(x.shape, np.float32)
        return (rng.standard_normal(x.shape) * 1e-2).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """3 optax updates from the shipped weights, saved by the JAX
    ``save_checkpoint``; then the 4th update."""
    d = tmp_path_factory.mktemp("jax_run")
    params = jax.tree.map(jnp.asarray, jax_load_npz(NPZ))
    tx, sched = jax_optimizer(LR, TOTAL, params=params)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    state = jax.jit(tx.init)(params)
    for k in range(3):
        params, state = update(_grads(params, k), state, params)
    path = str(d / "model_000000.ckpt")
    JT.save_checkpoint(path, jax.device_get(params), jax.device_get(state),
                       0)
    g4 = _grads(params, 3)
    np_tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    out = {"path": path, "sched": sched, "g4": np_tree(g4),
           "params3": np_tree(params)}
    for x64 in (False, True):
        with jax.enable_x64(x64):
            params4, state4 = update(g4, state, params)
        out[x64] = {"param": np_tree(params4),
                    "exp_avg": np_tree(state4.inner_state[0].mu),
                    "exp_avg_sq": np_tree(state4.inner_state[0].nu)}
    return out


def _port_from_file(path):
    payload = T.load_checkpoint(path)
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(payload["model"], strict=True)
    opt, scheduler, sched = make_optimizer(model, LR, TOTAL)
    load_optax_state(model, opt, scheduler, payload["opt_state"])
    return model, opt, scheduler, sched


def _rel(got, want):
    """max |got - want| over the leaf's largest |want|."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale else 1.0)


def test_resumed_adamw_step_equals_the_fourth_optax_update(jax_run):
    model, opt, scheduler, sched = _port_from_file(jax_run["path"])
    params = dict(model.named_parameters())
    assert sum(p.numel() for p in params.values()) == N_PARAMS
    # the learning rate of the next step: the schedule's at count 3
    lr = opt.param_groups[0]["lr"]
    assert scheduler.last_epoch == 3
    assert abs(lr - sched(3)) <= 1e-12
    assert abs(lr - float(jax_run["sched"](3))) <= 2.0 ** -21 * lr  # 4 ulps
    # moments only on parameters, none on a BN buffer
    on = {id(p) for p in opt.state}
    assert on == {id(p) for p in params.values()}
    assert not on & {id(b) for b in model.buffers()}
    assert all(float(s["step"]) == 3 for s in opt.state.values())

    grads = torch_leaves(jax_run["g4"])
    for n, p in params.items():
        p.grad = grads[n].clone()
    opt.step()
    scheduler.step()
    assert abs(opt.param_groups[0]["lr"] - sched(4)) <= 1e-12

    got = {n: {"param": p.detach(), **{k: opt.state[p][k] for k in (
        "exp_avg", "exp_avg_sq")}} for n, p in params.items()}
    assert all(float(opt.state[p]["step"]) == 4 for p in params.values())
    for x64, bound in ((True, {"param": 1e-6, "exp_avg": 1e-6,
                               "exp_avg_sq": 1e-6}),
                       (False, {"param": 1e-5, "exp_avg": 1e-6,
                                "exp_avg_sq": 1e-6})):
        want = {k: torch_leaves(v) for k, v in jax_run[x64].items()}
        worst = {k: max(_rel(got[n][k], want[k][n]) for n in params)
                 for k in bound}
        print(f"optax scalars in {64 if x64 else 32} bits, worst leaf:",
              worst)
        assert all(worst[k] <= bound[k] for k in bound), (x64, worst)


def _loaded_equal(got, want, path="payload"):
    """The same structure, types, dtypes and bits."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _loaded_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _loaded_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


def _globals(path):
    seen = set()

    class Recording(jax_checkpoint._Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            return super().find_class(module, name)
    with open(path, "rb") as f:
        Recording(f).load()
    return seen


def test_helper_layout_loads_as_the_jax_file(jax_run, tmp_path):
    """``tests/jax_pickle.py`` writes what JAX's ``save_checkpoint``
    wrote: the same globals, structure, dtypes and bits once read; its
    tree from the port's npz is the JAX package's import of it, and its
    seeded moments are masked where optax masks."""
    real = jax_checkpoint.read_jax_checkpoint(jax_run["path"])
    adam, _, sch = real["opt_state"].inner_state
    path = str(tmp_path / "helper.ckpt")
    jax_pickle.write_jax_checkpoint(path, real["params"], adam.mu, adam.nu,
                                    adam.count, sch.count, real["epoch"])
    assert checkpoint_format(path) == "jax"
    _loaded_equal(jax_checkpoint.read_jax_checkpoint(path), real)
    assert _globals(path) == _globals(jax_run["path"])

    tree = jax_pickle.jax_tree_from_state_dict(load_npz_checkpoint(NPZ))
    _loaded_equal(tree, jax.tree.map(np.asarray, jax_load_npz(NPZ)),
                  "tree")
    mu, nu = jax_pickle.seeded_moments(tree, 2, seed=0)
    is_node = lambda x: isinstance(x, jax_checkpoint.MaskedNode)  # noqa
    assert jax.tree.structure(jax.tree.map(is_node, mu, is_leaf=is_node)) \
        == jax.tree.structure(jax.tree.map(is_node, adam.mu, is_leaf=is_node))
    assert jax.tree.leaves(jax.tree.map(is_node, mu, is_leaf=is_node)) == \
        jax.tree.leaves(jax.tree.map(is_node, adam.mu, is_leaf=is_node))
    assert all(float(np.min(v)) >= 0 for v in jax.tree.leaves(nu))


_NO_JAX = r"""
import importlib.abc, sys
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "effi_mvs_plus_tpu"}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} may not be imported here")
        return None

sys.meta_path.insert(0, Refuse())
import torch
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint, load_state_dict
from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
from effi_mvs_plus_tpu_torch.train import trainer as T

npz, jax_file, bare, port = sys.argv[1:]
want = load_npz_checkpoint(npz)
for path in (npz, jax_file, bare, port):
    sd = load_state_dict(path)
    EffiMVS(EffiMVSConfig()).load_state_dict(sd, strict=True)
    for k, v in want.items():
        # the JAX tree and the bare file carry no BN batch counts: zeros
        if k.endswith("num_batches_tracked") and path in (jax_file, bare):
            v = torch.zeros_like(v)
        assert torch.equal(sd[k], v), (path, k)
assert "opt_state" in T.load_checkpoint(jax_file)
assert not any(m.split(".")[0] in FORBIDDEN for m in sys.modules)
print("ok", len(want))
"""


def test_every_format_loads_without_jax(tmp_path):
    """A JAX payload (from the shipped weights, through the JAX
    ``save_checkpoint``), a reference-style bare state dict without
    ``num_batches_tracked`` or the aliases, a port checkpoint and the
    shipped npz load through one ``load_state_dict`` to the npz's tensors,
    strictly, in a process whose imports of JAX, optax, orbax, flax and
    the JAX package fail."""
    params = jax_load_npz(NPZ)
    tx, _ = jax_optimizer(LR, TOTAL, params=params)
    jax_file = str(tmp_path / "model_000002.ckpt")
    JT.save_checkpoint(jax_file, params,
                       jax.device_get(tx.init(params)), 2)
    sd = load_npz_checkpoint(NPZ)
    bare = str(tmp_path / "reference.ckpt")
    torch.save({k: v for k, v in sd.items()
                if not k.endswith("num_batches_tracked")
                and not k.startswith(("update_block.", "CSP_R.", "CSP_C."))},
               bare)
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(sd, strict=True)
    opt, scheduler, _ = make_optimizer(model, LR, TOTAL)
    port = str(tmp_path / "model_000003.ckpt")
    T.save_checkpoint(port, model, opt, scheduler, 3)
    assert [checkpoint_format(p) for p in (NPZ, jax_file, bare, port)] == \
        ["npz", "jax", "torch", "torch"]
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, NPZ, jax_file, bare, port],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", str(len(sd))]


def test_orbax_directory_and_foreign_globals_are_refused(tmp_path):
    orbax_dir = tmp_path / "model_000004"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    for load in (checkpoint_format, load_state_dict, T.load_checkpoint):
        with pytest.raises(ValueError, match="orbax"):
            load(str(orbax_dir))

    foreign = tmp_path / "model_000005.ckpt"
    with open(foreign, "wb") as f:
        pickle.dump({"params": {}, "hook": os.system}, f)
    assert checkpoint_format(str(foreign)) == "jax"
    for load in (load_state_dict, T.load_checkpoint):
        with pytest.raises(pickle.UnpicklingError,
                           match=r"names the global (posix|nt)\.system"):
            load(str(foreign))


def test_latest_checkpoint_over_both_packages(jax_run, tmp_path):
    """The newest epoch wins, whichever package wrote it; an orbax
    directory counts, and is refused when it is the newest."""
    logdir = tmp_path / "run"
    logdir.mkdir()
    jax_file = logdir / "model_000001.ckpt"
    jax_file.write_bytes(open(jax_run["path"], "rb").read())
    assert T.latest_checkpoint(str(logdir)) == str(jax_file)
    payload = T.load_checkpoint(str(jax_file))
    assert sorted(payload) == ["epoch", "model", "opt_state"]
    assert payload["epoch"] == 0
    for k, v in params_from_jax(jax_run["params3"]).items():
        assert torch.equal(payload["model"][k], v), k

    model = EffiMVS(EffiMVSConfig())
    opt, scheduler, _ = make_optimizer(model, LR, TOTAL)
    T.save_checkpoint(str(logdir / "model_000000.ckpt"), model, opt,
                      scheduler, 0)
    assert T.latest_checkpoint(str(logdir)) == str(jax_file)
    T.save_checkpoint(str(logdir / "model_000002.ckpt"), model, opt,
                      scheduler, 2)
    assert T.latest_checkpoint(str(logdir)).endswith("model_000002.ckpt")
    (logdir / "model_000003").mkdir()
    newest = T.latest_checkpoint(str(logdir))
    assert newest == str(logdir / "model_000003")
    with pytest.raises(ValueError, match="orbax"):
        T.load_checkpoint(newest)


def test_save_npz_matches_the_jax_function(tmp_path):
    """On a ``.ckpt`` written by ``torch.save`` (the reference's
    ``{"model": state_dict}``), the port's ``save_npz`` writes the JAX
    function's keys and arrays, bitwise; the port's
    ``load_torch_checkpoint`` reads the same file strictly."""
    from effi_mvs_plus_tpu_torch.io import load_torch_checkpoint
    sd = load_npz_checkpoint(NPZ)
    ckpt = str(tmp_path / "model.ckpt")
    torch.save({"model": sd}, ckpt)
    save_npz(ckpt, str(tmp_path / "port.npz"))
    jax_io.save_npz(ckpt, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
    loaded = load_torch_checkpoint(ckpt)
    EffiMVS(EffiMVSConfig()).load_state_dict(loaded, strict=True)
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
