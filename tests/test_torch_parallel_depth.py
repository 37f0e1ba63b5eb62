"""Depth sharding of the cost volume (``--shard_policy depth`` and the JAX
CLI's default ``views,depth``) on the CPU, in gloo ranks.

* The collectives and layers of a D-block, in two spawned ranks
  (``tests/_torch_depth_rank.py``): the halo exchange and the gather
  along D, forward and backward, and train-mode 3-D conv + BN + ReLU
  blocks (stride 1, stride 2, the stride-2 transpose of CostRegNet's
  ``conv6``/``conv7``, the (1,2,2) transpose of the CSP blocks), each on
  its block with halos against the whole volume's op sliced, to 1e-6
  relative; ``CostRegNet`` and ``CSPBlock`` in eval mode with their fused
  3-D layers (plain version) on the D-block, each layer with its halo;
  and the stage-1 entropy with its max and sums from the group.
* The equivalence gate (``parallel/equivalence.py``) of the depth layouts
  against the single process on the gate's batch (B=2, 3 views, 64x96,
  ``model_dtu.npz``): ``depth`` and ``views_depth`` in two ranks,
  ``data_views_depth`` and ``depth4`` in four, at the JAX gate's bounds
  (|Δloss| <= 1e-4 (1 + |loss|), max |Δ| <= 2.5e-3 after one AdamW
  step) with every gradient leaf within rel-l2 5e-2.
* The train CLI: ``views,depth`` by default, a split the halos cannot
  serve refused with its reason, and ``--model_parallel 2`` fine-tuning
  in two ranks under the default layout."""

import json
import math
import os

import pytest
import torch
import torch.multiprocessing as mp

import _torch_depth_rank as unit
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
from effi_mvs_plus_tpu_torch.parallel import equivalence as E
from effi_mvs_plus_tpu_torch.parallel import mesh as par

from test_torch_blend import NPZ, _build_blend_tree
from test_torch_parallel import _two_ranks


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unit_errors(tmp_path_factory):
    """Every check of ``_torch_depth_rank.CHECKS`` in one spawn of two
    ranks: its worst relative error over the ranks."""
    out = str(tmp_path_factory.mktemp("depth_units") / "errors.json")
    ctx = mp.start_processes(unit.main, args=(2, E.free_port(), out),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(120):
        if ctx.join(timeout=1.0):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise TimeoutError("the depth unit ranks ran past 120 s")
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("check", sorted(unit.CHECKS))
def test_depth_block_op_matches_the_whole_volume(unit_errors, check):
    assert unit_errors[check] <= 1e-6, unit_errors


def test_depth_blocks_and_slices():
    assert par.depth_split_error(48, 2, 4) is None
    assert par.depth_split_error(48, 4, 4) is None
    assert par.depth_split_error(8, 8) is None
    assert "multiple of 4" in par.depth_split_error(48, 8, 4)
    assert "evenly" in par.depth_split_error(8, 3)
    assert "evenly" in par.depth_split_error(8, 16)
    # without depth sharding, all of D before and after the view sums
    assert par.depth_slices(48, 4) == (slice(None), slice(None))
    views = par.ShardingPolicy(par.Mesh(1, 2))
    assert views.depth_block(48, 4) == (0, 48)
    depth = par.ShardingPolicy(par.Mesh(1, 4), shard_views=False,
                               shard_depth=True)
    assert depth.depth_block(48, 4) == (0, 12)
    assert depth.depth_slices(8) == (slice(0, 2), slice(None))
    both = par.ShardingPolicy(par.Mesh(1, 2), shard_depth=True)
    assert both.depth_slices(96, 4) == (slice(None), slice(0, 48))
    with pytest.raises(ValueError, match="GSPMD pads"):
        depth.depth_block(40, 4)


@pytest.fixture(scope="module")
def refs():
    """The single process's step on the gate's batch, on the CPU."""
    return E.references(load_npz_checkpoint(NPZ), EffiMVSConfig(),
                        E.train_batch(), "cpu")


def _held(report, names, ref_loss):
    for name in names:
        r = report[name]
        assert r["dloss"] <= E.LOSS_RTOL * (1 + abs(ref_loss)), (name, r)
        assert r["max_dparam"] <= E.PARAM_ATOL, (name, r)
        assert r["grad_worst_rel_l2"] < E.GRAD_REL, (name, r)


def test_two_ranks_depth_layouts_match_the_single_process(refs, tmp_path):
    report = E.spawn(2, ["depth", "views_depth"], refs, str(tmp_path),
                     device="cpu", timeout=120)
    _held(report, ("depth", "views_depth"), refs["step"][0])


def test_four_ranks_depth_layouts_match_the_single_process(refs, tmp_path):
    report = E.spawn(4, ["data_views_depth", "depth4"], refs,
                     str(tmp_path), device="cpu", timeout=120, threads=1)
    _held(report, ("data_views_depth", "depth4"), refs["step"][0])


def test_train_cli_defaults_to_views_depth():
    from effi_mvs_plus_tpu_torch.cli import train
    assert train.build_parser().parse_args([]).shard_policy == "views,depth"
    assert train.build_parser("blend_finetune").parse_args(
        []).shard_policy == "views,depth"


@pytest.mark.parametrize("flags,stage", [
    (["--model_parallel", "3"], "stage 2"),
    (["--model_parallel", "8", "--shard_policy", "depth"], "stage 1"),
    (["--model_parallel", "16", "--ndepths", "64,8,8",
      "--shard_policy", "views,depth"], "stage 2")])
def test_train_cli_refuses_a_split_the_halos_cannot_serve(flags, stage):
    from effi_mvs_plus_tpu_torch.cli import train
    with pytest.raises(SystemExit, match=f"{stage}: .*GSPMD pads"):
        train.main(flags + ["--device", "cpu"])


def test_train_cli_model_parallel_in_two_ranks(tmp_path):
    """``--mode finetune --model_parallel 2`` in two processes with
    torchrun's environment, under the default ``views,depth``: each rank
    warps its own source view and keeps 48 of the 96 stage-1 hypotheses;
    rank 0 alone writes the checkpoint."""
    root = str(tmp_path / "tree")
    listfile = _build_blend_tree(root)
    logdir = str(tmp_path / "run")
    outs = _two_ranks("train", [
        "--mode", "finetune", "--device", "cpu", "--trainpath", root,
        "--trainlist", listfile, "--testlist", listfile, "--logdir", logdir,
        "--loadckpt", NPZ, "--batch_size", "1", "--model_parallel", "2",
        "--trainviews", "3", "--testviews", "3", "--num_workers", "1",
        "--epochs", "1", "--summary_freq", "1"])
    assert "saved" in outs[0] and "saved" not in outs[1]
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and all(math.isfinite(v) for v in losses)
