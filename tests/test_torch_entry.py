"""The port's compile-check entry points (``effi_mvs_plus_tpu_torch/
entry.py``) on the CPU: ``entry`` against the JAX package's
``__graft_entry__.entry`` on the same inputs, with the JAX entry's own
parameters (``init_params(PRNGKey(0))``, read from its ``fn``'s closure
rather than drawn a second time, which takes a minute on the CPU)
carried across by ``params_from_jax`` and the JAX forward on its CPU
path (XLA, as its own tests run it), within the fp32 map tolerance of
``tests/test_model_golden.py`` (0.5% of the map's range + 0.5 mm); and
``dryrun_multichip(2)``, the gate of ``views,depth`` and ``spatial`` in
two gloo ranks at the JAX bounds."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from effi_mvs_plus_tpu_torch import entry
from effi_mvs_plus_tpu_torch.io import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _closure(fn):
    return {name: cell.cell_contents for name, cell in
            zip(fn.__code__.co_freevars, fn.__closure__)}


def test_entry_matches_the_jax_entry():
    fn_j, args_j = graft.entry()
    want = np.asarray(jax.jit(fn_j)(*args_j))
    sd = params_from_jax(_closure(fn_j)["params"])
    fn, args = entry.entry(device="cpu", state_dict=sd)
    for a, b in zip(args, args_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args).numpy()
    assert got.shape == want.shape == entry.SHAPE[:1] + entry.SHAPE[2:]
    assert np.isfinite(got).all()
    tol = 0.005 * float(want.max() - want.min()) + 0.5
    assert float(np.abs(got - want).max()) < tol


def test_entry_seeds_its_weights():
    fn, args = entry.entry(device="cpu")
    a = fn(*args)
    fn2, args2 = entry.entry(device="cpu")
    assert torch.equal(a, fn2(*args2))


def test_dryrun_multichip_two_ranks():
    report = entry.dryrun_multichip(2, device="cpu")
    assert set(report) >= {"views,depth", "spatial"}
    assert report["world"] == 2


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
