"""The port's multi-process parallelism on the CPU (gloo): the helpers of
``parallel/distributed.py`` on one process, the policy hooks without a
policy, ``Loader(indices=...)`` against the JAX loader, and the
equivalence gate (``parallel/equivalence.py``) in spawned processes: a
data-parallel step (data 2 x model 1), a view-sharded step (1 x 2), both
(2 x 2, four processes) and the view-sharded engine, each against the
single process at the JAX gate's bounds (|Δloss| <= 1e-4 (1 + |loss|),
max |Δ| <= 2.5e-3 over the parameters and BN statistics after one AdamW
step), with every gradient within rel-l2 5e-2 of the single process's
and the engine's maps within the fp32 map tolerance; then the train CLI
in two ranks with torchrun's environment, where rank 0 alone writes the
checkpoint and the metrics, and the inference CLIs' partitions; and each
of three faults planted in the data-parallel ranks fails the gate."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.data.loader import Loader as JaxLoader
from effi_mvs_plus_tpu.parallel import partition as jax_partition
from effi_mvs_plus_tpu_torch import parallel
from effi_mvs_plus_tpu_torch.data.loader import Loader
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
from effi_mvs_plus_tpu_torch.parallel import equivalence as E
from effi_mvs_plus_tpu_torch.parallel import mesh as par

from test_torch_blend import N_REFS, NPZ, _build_blend_tree
from test_torch_cli_train import _assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_gate_faults as faults  # noqa: E402

DIST_ENV = ("RANK", "WORLD_SIZE", "PROCESS_ID", "NUM_PROCESSES",
            "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS")



@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    several workers on the host's cores, and torch's threads, when they
    outnumber the cores, slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def test_single_process_helpers(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize(device="cpu") is False
    monkeypatch.setenv("NUM_PROCESSES", "1")
    assert parallel.initialize(device="cpu") is False
    assert (parallel.world_size(), parallel.rank()) == (1, 0)
    assert parallel.is_main()
    parallel.barrier()
    assert parallel.mean_metrics({"a": torch.tensor(1.5), "b": 2}) == \
        {"a": 1.5, "b": 2.0}
    for n, p in ((3, 0), (3, 1), (3, 2), (4, 3)):
        assert parallel.partition(range(10), n, p) == \
            jax_partition(range(10), n, p)
    assert parallel.partition(["a", "b", "c"]) == ["a", "b", "c"]
    assert parallel.rank_device("cpu") == torch.device("cpu")
    assert parallel.rank_device("cuda:1") == torch.device("cuda:1")


def test_policy_hooks_are_identities_without_a_policy():
    x, y = torch.ones(2, 3), torch.zeros(2, 1)
    assert par.reduce_data(x) is x
    assert par.data_parallel() == 1
    assert par.dropout_rows(3) == (3, 0)
    assert par.local_source_views(6) == (0, 6)
    a, b = par.sum_views(x, y)
    assert a is x and b is y
    with par.view_stats(6, has_ref=True):
        a, b = par.gather_view_stats(x, y)
        assert a is x and b is y


def test_view_blocks_and_refused_layouts():
    assert par.view_blocks(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert par.view_blocks(6, 2) == [(0, 3), (3, 6)]
    with pytest.raises(ValueError, match="cannot be split"):
        par.view_blocks(2, 3)
    assert par.layout_kinds("views") == par.layout_kinds(" views,") == \
        {"views"}
    assert par.layout_kinds("views,depth") == {"views", "depth"}
    assert par.layout_kinds("depth") == {"depth"}
    # every combination is taken, as the JAX CLI builds its policy
    assert par.layout_kinds("depth,spatial") == {"depth", "spatial"}
    assert par.layout_kinds("spatial") == {"spatial"}
    with pytest.raises(ValueError, match="unknown layout"):
        par.layout_kinds("rows")
    with pytest.raises(ValueError, match="no model-axis layout"):
        par.layout_kinds(" ,")
    # a grid of one model rank shards nothing; of two, the views (and,
    # asked, the depths)
    assert not par.ShardingPolicy(par.Mesh(1, 1)).shard_views
    assert par.ShardingPolicy(par.Mesh(1, 2)).shard_views
    assert not par.ShardingPolicy(par.Mesh(1, 2)).shard_depth
    assert not par.ShardingPolicy(par.Mesh(1, 1), shard_depth=True).shard_depth


class _Samples:
    def __init__(self, n=9):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"x": rng.normal(size=(2, 3)).astype(np.float32),
                "d": {"s": np.float32(i)}, "filename": f"{i:04d}"}


@pytest.mark.parametrize("kw", [{"indices": [1, 3, 5, 7, 6]},
                                {"indices": range(0, 8, 2),
                                 "drop_last": True},
                                {"indices": None, "shuffle": False}])
def test_loader_indices_match_jax_loader(kw):
    kw = {"shuffle": True, **kw}
    port = Loader(_Samples(), 2, seed=4, num_workers=1, **kw)
    ref = JaxLoader(_Samples(), 2, seed=4, num_workers=1, **kw)
    assert len(port) == len(ref)
    for _ in range(2):                            # two epochs
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            _assert_same(g, w)


@pytest.fixture(scope="module")
def refs():
    """The single process's step and maps on the gate's batch (B=2,
    3 views, 64x96) from model_dtu.npz, on the CPU."""
    batch = E.train_batch()
    request = {k: batch[k] for k in ("imgs", "proj_matrices",
                                     "depth_values")}
    return E.references(load_npz_checkpoint(NPZ), EffiMVSConfig(), batch,
                        "cpu", request)


def test_memory_phases_leave_the_step_unchanged(refs):
    """The references' step ran under ``memory_phases``: the same step
    without it gives the same loss and gradients bit for bit, and the
    saved bytes are split over the network's top-level modules."""
    loss, _, grads = E.train_step(refs["state"], refs["cfg"], refs["batch"],
                                  "cpu")
    assert loss == refs["step"][0]
    assert all(torch.equal(g, refs["step"][2][k]) for k, g in grads.items())
    saved = refs["memory"]["saved_gib"]
    assert {"feature", "cost_regularization", "PixelwiseNet",
            "update_block_depth1", "other"} <= set(saved)
    assert all(v > 0 for v in saved.values())


def test_two_ranks_match_the_single_process(refs, tmp_path):
    report = E.spawn(2, ["data", "views", "engine"], refs, str(tmp_path),
                     device="cpu", timeout=120)
    assert report["backend"] == "gloo"
    for name in ("data", "views"):
        r = report[name]
        assert r["dloss"] <= E.LOSS_RTOL * (1 + abs(refs["step"][0]))
        assert r["max_dparam"] <= E.PARAM_ATOL
        assert r["grad_worst_rel_l2"] < E.GRAD_REL
    assert report["engine"]["depth_err_over_tolerance"] < 1


def test_four_ranks_data_and_views_match_the_single_process(refs, tmp_path):
    report = E.spawn(4, ["data_views"], refs, str(tmp_path), device="cpu",
                     timeout=120, threads=1)
    r = report["data_views"]
    assert r["dloss"] <= E.LOSS_RTOL * (1 + abs(refs["step"][0]))
    assert r["max_dparam"] <= E.PARAM_ATOL


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_gate_catches_planted_faults(refs, tmp_path, fault):
    """Each fault the data axis can make (per-rank BN statistics, a
    per-rank dropout mask, per-rank loss normalisation), planted in both
    ranks, fails the gate (``scripts/torch_gate_faults.py`` reads them)."""
    report = E.spawn(2, ["data"], refs, str(tmp_path), device="cpu",
                     timeout=120, setup=faults.FAULTS[fault], check=False)
    assert faults.caught_by(refs["step"][0], report["data"])
    with pytest.raises(AssertionError):
        E.check_step("data", refs["step"][0], report["data"])


def test_train_cli_in_two_ranks_rank0_writes(tmp_path):
    """``--mode finetune --data_parallel 2`` in two processes with
    torchrun's environment: each rank takes 1 of the global batch of 2
    from its half of the 2 samples, so an epoch is 1 step; rank 0 alone
    writes the checkpoint and the metrics rows."""
    root = str(tmp_path / "tree")
    listfile = _build_blend_tree(root)
    logdir = str(tmp_path / "run")
    outs = _two_ranks("train", [
        "--mode", "finetune", "--device", "cpu", "--trainpath", root,
        "--trainlist", listfile, "--testlist", listfile, "--logdir", logdir,
        "--loadckpt", NPZ, "--batch_size", "2", "--data_parallel", "2",
        "--trainviews", "3", "--testviews", "3", "--num_workers", "1",
        "--epochs", "1", "--summary_freq", "1"])
    assert "saved" in outs[0] and "saved" not in outs[1]
    assert sorted(os.listdir(logdir))[:2] == ["metrics.jsonl",
                                              "model_000000.ckpt"]
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    steps = [r["step"] for r in rows if "train/loss" in r]
    assert steps == list(range(1, N_REFS // 2 + 1))
    assert sum("eval/loss" in r for r in rows) == 1
    assert all(np.isfinite(r["train/loss"]) for r in rows
               if "train/loss" in r)


def _two_ranks(cli, args, timeout=120):
    """Run ``cli``'s main with ``args`` as two ranks with torchrun's
    environment (``tests/_torch_rank.py``); their outputs, each rank's
    exit code held to 0."""
    argv = [sys.executable, os.path.join(ROOT, "tests", "_torch_rank.py"),
            cli, *args]
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(E.free_port()), OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen(argv, cwd=ROOT, env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


@pytest.mark.parametrize("cli,flags,want", [
    ("test_dtu", ["--testlist", "LIST"], ("2 scans", "1 scans")),
    ("test_tank", ["--scenes", "Horse", "Family", "Train"],
     ("scenes ['Horse', 'Train']", "scenes ['Family']")),
    ("test_tank", ["--scenes", "Horse", "Family", "--shard_views"],
     ("scenes ['Horse', 'Family']", "scenes ['Horse', 'Family']"))])
def test_inference_clis_partition_over_two_ranks(tmp_path, cli, flags,
                                                 want):
    """Each rank takes its round-robin share of the scans or scenes; with
    ``--shard_views`` every rank takes every scene (they split the views
    of each request instead)."""
    listfile = tmp_path / "list.txt"
    listfile.write_text("scan1\nscan4\nscan9\n")
    flags = [str(listfile) if f == "LIST" else f for f in flags]
    outs = _two_ranks(cli, ["--device", "cpu", "--testpath", str(tmp_path),
                            "--loadckpt", "x.npz", "--skip_depth",
                            "--skip_fusion", *flags])
    for r in range(2):
        assert f"process {r}: {want[r]}" in outs[r], outs[r]
