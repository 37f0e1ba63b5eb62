"""The port's tracer (``utils/profiling.py``) on the CPU: the off path,
spans and units across an engine batch, a scene and a train step at a
tiny size, the upload's byte counter, nested tracing blocks, the
buffer's bound and the spans in a ``torch.profiler`` trace.  Imports no
JAX."""

import json

import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu_torch.data import cams as camio
from effi_mvs_plus_tpu_torch.infer import InferenceEngine
from effi_mvs_plus_tpu_torch.infer.engine import SLOT_BYTES, chunk_plan
from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
from effi_mvs_plus_tpu_torch.train.trainer import make_train_step
from effi_mvs_plus_tpu_torch.utils import profiling
from effi_mvs_plus_tpu_torch.utils.profiling import span, tracing

H, W, V = 64, 96, 3
STAGES = ("model.stage1", "model.stage2", "model.stage3")


def make_batch(B=1, seed=0, with_depth=False, H=H, W=W, V=V):
    """A batch in the loader's layout (numpy), tiny by default."""
    rng = np.random.default_rng(seed)
    f = 1.3 * W / 8
    intr = np.array([[f, 0, W / 16], [0, f, H / 16], [0, 0, 1]], np.float32)
    projs = []
    for v in range(V):
        E = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.03 * v), np.sin(0.03 * v)
        E[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        E[:3, 3] = [10.0 * v, 2.0 * v, 1.0 * v]
        projs.append(camio.stage_proj_matrices(E, intr))
    batch = {"imgs": rng.uniform(0, 1, (B, V, H, W, 3)).astype(np.float32),
             "proj_matrices": {k: np.broadcast_to(
                 np.stack([p[k] for p in projs])[None], (B, V, 2, 4, 4)
             ).copy() for k in ("stage1", "stage2", "stage3", "stage4")},
             "depth_values": np.broadcast_to(camio.inverse_depth_values(
                 425.0, 2.5 * 0.53, 64)[None], (B, 64)).copy()}
    if with_depth:
        batch["depth"] = {f"stage{k}": rng.uniform(
            450, 900, (B, H // 2 ** (4 - k), W // 2 ** (4 - k))
        ).astype(np.float32) for k in range(1, 5)}
        batch["mask"] = {k: np.ones_like(v)
                         for k, v in batch["depth"].items()}
    return batch


@pytest.fixture(scope="module")
def state_dict():
    torch.manual_seed(0)
    return EffiMVS(EffiMVSConfig()).state_dict()


def _no_cuda_events(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", refuse)


def test_span_off_is_one_shared_object_that_records_nothing(monkeypatch):
    _no_cuda_events(monkeypatch)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a: pytest.fail("record_function called"))
    first = span("a")
    assert span("b", torch.device("cuda")) is first
    with first, span("c"):
        pass
    with tracing() as rec:
        pass
    assert rec.spans == [] and rec.dropped == 0
    assert span("d") is first                      # off again after


def test_engine_batch_spans_units_and_bytes(state_dict, monkeypatch):
    _no_cuda_events(monkeypatch)
    engine = InferenceEngine(state_dict, device="cpu")
    batches = [make_batch(seed=s) for s in (0, 1)]
    with tracing() as rec:
        outs = [engine.infer_batch(b) for b in batches]
    roots = [s for s in rec.spans if s.name == "engine.batch"]
    assert len(roots) == 2 and rec.units() == 2
    assert [r.parent for r in roots] == [None, None]
    assert roots[1].unit == roots[0].unit + 1
    for root in roots:
        mine = [s for s in rec.spans if s.unit == root.unit]
        parents = {s.name: s.parent for s in mine}
        assert parents == {"engine.batch": None,
                           "engine.upload": "engine.batch",
                           "engine.forward": "engine.batch",
                           "model.features": "engine.forward",
                           **{st: "engine.forward" for st in STAGES},
                           "model.gru_iter": "model.stage3",
                           "engine.readback": "engine.batch"}
        iters = [s for s in mine if s.name == "model.gru_iter"]
        assert [s.parent for s in iters] == [st for st in STAGES
                                             for _ in range(3)]
        for s in mine:                    # nested inside the unit's root
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            assert s.device_ms is None    # the CPU times no device
    # the order of the spans is the order they were opened
    names = [s.name for s in rec.spans if s.unit == roots[0].unit]
    assert names[:4] == ["engine.batch", "engine.upload", "engine.forward",
                         "model.features"]
    assert names[-1] == "engine.readback"
    upload = sum(b["imgs"].nbytes + b["depth_values"].nbytes
                 + sum(b["proj_matrices"][k].nbytes
                       for k in ("stage1", "stage2", "stage3"))
                 for b in batches)
    assert rec.counters == {"engine.upload_bytes": upload}
    assert [d.shape for d, _ in outs] == [(1, H, W)] * 2


def test_a_cpu_engine_copies_plainly_and_stages_nothing(state_dict):
    """On the CPU the upload is the plain ``torch.as_tensor``: the arrays'
    own memory, contiguous or not, no pinned ring and no staging
    counter."""
    engine = InferenceEngine(state_dict, device="cpu")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    arrays = (a, a[:, ::2])
    with tracing() as rec:
        outs = [engine._to_device(x) for x in arrays]
    assert rec.counters == {"engine.upload_bytes": sum(x.nbytes
                                                        for x in arrays)}
    for x, t in zip(arrays, outs):
        assert np.shares_memory(t.numpy(), x)
        assert np.array_equal(t.numpy(), x)
    assert engine._ring is None


@pytest.mark.parametrize("nbytes,slot", [(0, 8), (8, 8), (9, 8), (43, 8),
                                         (3 * SLOT_BYTES + 1, SLOT_BYTES)])
def test_the_chunk_plan_covers_every_byte_once(nbytes, slot):
    """The ring's plan: empty for no bytes, else back-to-back ranges of at
    most a slot from 0 to the end, as few as the slot allows."""
    plan = chunk_plan(nbytes, slot)
    assert len(plan) == -(-nbytes // slot)
    assert all(0 < stop - start <= slot for start, stop in plan)
    edges = [0] + [stop for _, stop in plan]
    assert plan == list(zip(edges[:-1], edges[1:])) and edges[-1] == nbytes


def test_a_scene_traces_each_batch_as_its_own_block(state_dict, tmp_path):
    """``save_scene_depths`` opens a tracing block a batch: an outer block
    sees one ``engine.batch`` unit a batch, and tracing is off after."""
    engine = InferenceEngine(state_dict, device="cpu")
    batches = [dict(make_batch(seed=s), filename=[f"scan1/{{}}/{s:08d}{{}}"])
               for s in (0, 1)]
    with tracing() as rec:
        stats = engine.save_scene_depths(batches, str(tmp_path),
                                         verbose=False)
    assert stats["maps"] == 2 and stats["device_s"] is None
    roots = [s for s in rec.spans if s.parent is None]
    assert [r.name for r in roots] == ["engine.batch"] * 2
    assert rec.units() == 2 and "engine.readback" not in {
        s.name for s in rec.spans}
    assert (tmp_path / "scan1" / "depth_est" / "00000001.pfm").exists()
    assert span("after") is span("other")


def test_train_step_spans(state_dict):
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(state_dict)
    opt, sched, _ = make_optimizer(model, 1e-3, 100, 1e-3)
    step = make_train_step(model, opt, sched, device="cpu")
    with tracing() as rec:
        for s in (0, 1):
            step(make_batch(seed=s, with_depth=True))
    roots = [s for s in rec.spans if s.name == "train.step"]
    assert len(roots) == 2 and rec.units() == 2
    for root in roots:
        mine = [(s.name, s.parent) for s in rec.spans
                if s.unit == root.unit and s.parent in ("train.step", None)]
        assert mine == [("train.step", None),
                        ("train.upload", "train.step"),
                        ("train.forward", "train.step"),
                        ("train.optimizer", "train.step"),
                        ("train.backward", "train.step"),
                        ("train.optimizer", "train.step")]
        stages = [s.parent for s in rec.spans
                  if s.unit == root.unit and s.name in STAGES]
        assert stages == ["train.forward"] * 3


def test_nested_blocks_and_the_bound(monkeypatch):
    with tracing() as outer:
        with span("a"):
            pass
        with tracing() as inner:
            with span("b"):
                with span("c"):
                    profiling.count("test.things", 3)
        with span("d"):
            pass
    assert [s.name for s in inner.spans] == ["b", "c"]
    assert [s.name for s in outer.spans] == ["a", "b", "c", "d"]
    assert [s.parent for s in outer.spans] == [None, None, "b", None]
    assert [s.unit for s in outer.spans][1:3] == [outer.spans[1].unit] * 2
    assert inner.counters == outer.counters == {"test.things": 3}
    assert inner.anchor == outer.anchor
    monkeypatch.setattr(profiling, "CAPACITY", 2)
    with tracing() as rec:
        for name in "xyz":
            with span(name):
                pass
    assert [s.name for s in rec.spans] == ["x", "y"] and rec.dropped == 1


def test_profile_trace_shows_the_spans(tmp_path):
    with profiling.profile_trace(str(tmp_path), device="cpu"):
        with span("test.outer"):
            with span("test.inner"):
                torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"test.outer", "test.inner"} <= names
    assert span("test.after") is span("test.other")   # tracing off again
