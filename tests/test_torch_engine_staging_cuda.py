"""The engine's pinned staging on the card (``infer/engine.py``
``_PinnedRing``, ``_to_host``): uploads bitwise equal to the plain copy
around the ring's edges, the staging counters, answers that no later
call overwrites, and ``save_scene_depths`` writing what ``infer_batch``
returns.  Marked ``cuda``: without a GPU every test skips.  On a GPU
machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_engine_staging_cuda.py``.  Imports no JAX."""

from pathlib import Path

import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu_torch.data.pfm import read_pfm
from effi_mvs_plus_tpu_torch.infer.engine import (SLOT_BYTES, SLOTS,
                                                  InferenceEngine,
                                                  chunk_plan)
from effi_mvs_plus_tpu_torch.utils.profiling import tracing
from test_torch_tracing import make_batch

pytestmark = pytest.mark.cuda

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "model_dtu.npz"
H, W, V = 256, 320, 5           # a small image, the published 5 views


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    return InferenceEngine(load_state_dict(str(CKPT)),
                           EffiMVSConfig(compute_dtype=torch.bfloat16),
                           device=torch.device("cuda"))


def _random_bytes(nbytes, dtype, seed):
    """An array of ``nbytes`` random bytes (NaNs and all) as ``dtype``."""
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).view(dtype)


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("nbytes,dtype,shape", [
    (SLOT_BYTES // 2 + 4, np.float32, (-1,)),               # under a slot
    (3 * SLOT_BYTES + 1000, np.float32, (2, -1)),           # not a multiple
    (SLOTS * SLOT_BYTES + 2 * 8 * 1001, np.float64, (2, -1)),  # past the ring
])
def test_a_staged_upload_is_the_plain_copy(engine, nbytes, dtype, shape):
    a = _random_bytes(nbytes, dtype, nbytes).reshape(shape)
    with tracing() as rec:
        got = engine._to_device(a)
    want = torch.from_numpy(a).to("cuda")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.device == want.device
    assert torch.equal(_bytes(got), _bytes(want))
    assert rec.counters == {"engine.upload_bytes": nbytes,
                            "engine.upload_staged_bytes": nbytes,
                            "engine.upload_chunks": len(chunk_plan(nbytes))}


def test_a_strided_view_takes_the_plain_copy(engine):
    a = _random_bytes(4 * 64 * 96 * 3, np.float32, 7).reshape(64, 96, 3)
    view = a[:, ::2]
    with tracing() as rec:
        got = engine._to_device(view)
    assert torch.equal(_bytes(got), _bytes(torch.from_numpy(
        np.ascontiguousarray(view)).to("cuda")))
    assert rec.counters == {"engine.upload_bytes": view.nbytes}


def test_answers_are_the_calls_own_and_every_byte_is_staged(
        engine, tmp_path, monkeypatch):
    """Two batches: the first call's maps are unchanged by the second's
    and share no memory with them; every upload byte went through the
    ring, in the plan's chunks.  ``save_scene_depths`` over three
    batches writes the maps that three ``infer_batch`` calls return.
    cuDNN's default algorithms do not repeat a forward bitwise (two
    calls on one batch differ by up to about 1 mm here), so the test
    asks for its deterministic ones."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batches = [make_batch(2, seed=s, H=H, W=W, V=V) for s in (0, 1, 2)]
    engine.infer_batch(batches[0])                 # packs the frozen weights
    with tracing() as rec:
        first = engine.infer_batch(batches[0])
    kept = [x.copy() for x in first]
    second = engine.infer_batch(batches[1])
    for x, y, z in zip(first, kept, second):
        assert np.array_equal(x, y) and not np.array_equal(x, z)
        assert not np.shares_memory(x, z)
    arrays = [batches[0]["proj_matrices"][f"stage{s}"] for s in (1, 2, 3)] \
        + [batches[0]["imgs"], batches[0]["depth_values"]]
    c = rec.counters
    assert c["engine.upload_staged_bytes"] == c["engine.upload_bytes"] == \
        sum(x.nbytes for x in arrays)
    assert c["engine.upload_chunks"] == sum(len(chunk_plan(x.nbytes))
                                            for x in arrays)

    answers = [engine.infer_batch(b) for b in batches]
    scene = [dict(b, filename=[f"scan1/{{}}/{3 * i + r:08d}{{}}"
                               for r in range(2)])
             for i, b in enumerate(batches)]
    stats = engine.save_scene_depths(scene, str(tmp_path), verbose=False)
    assert stats["maps"] == 6
    for i, (depth, conf) in enumerate(answers):
        for r in range(2):
            name = f"{3 * i + r:08d}.pfm"
            d, _ = read_pfm(str(tmp_path / "scan1" / "depth_est" / name))
            cf, _ = read_pfm(str(tmp_path / "scan1" / "confidence" / name))
            assert np.array_equal(d, depth[r]), (i, r)
            assert np.array_equal(cf, conf[r]), (i, r)
