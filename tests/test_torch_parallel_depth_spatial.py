"""``--shard_policy depth,spatial`` and ``views,depth,spatial`` on the CPU,
in gloo ranks.  As in the JAX package, one model axis and no tensor split
along two: the 2-D activations by image rows, the cost volumes by
hypotheses.

* Unit checks in two spawned ranks (``tests/_torch_depth_spatial_rank.py``),
  to 1e-6 relative: ``CostRegNet`` and a CSP block on the rank's D-block
  over all rows (inside ``row_blocks(False)``, as the forward runs them)
  against the whole volume's, forward, backward and running statistics;
  BN's element counts there and on a row block against the whole
  tensor's; a module inside both block contexts at once raises.
* The equivalence gate (``parallel/equivalence.py``) against the single
  process (``model_dtu.npz``): ``depth_spatial`` and
  ``views_depth_spatial`` in two ranks, ``depth_spatial4`` (128 rows:
  stage 1 4 + 4 + 4 + 4, 48/8/8 as 12/2/2) and ``data_depth_spatial`` in
  four, at the JAX gate's bounds (|Δloss| <= 1e-4 (1 + |loss|), max |Δ|
  <= 2.5e-3 after one AdamW step) with every gradient leaf within rel-l2
  5e-2; and the gate fails when the gradients are averaged over the model
  group only for the depth-sharded modules (under this layout every
  module runs on a block).
* The train CLI: both layouts taken, a split that fails D or H refused
  with its reason, and fine-tuning in two ranks under each layout."""

import json
import math
import os

import pytest
import torch
import torch.multiprocessing as mp

import _torch_depth_spatial_rank as unit
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
from effi_mvs_plus_tpu_torch.parallel import equivalence as E
from effi_mvs_plus_tpu_torch.parallel import mesh as par

from test_torch_blend import NPZ, _build_blend_tree
from test_torch_parallel import _two_ranks
from test_torch_parallel_spatial import _Rows


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
    """Every check of ``_torch_depth_spatial_rank.CHECKS`` in one spawn of
    two ranks: its worst relative error over the ranks."""
    out = str(tmp_path_factory.mktemp("depth_spatial_units") / "errors.json")
    ctx = mp.start_processes(unit.main, args=(2, E.free_port(), out),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(120):
        if ctx.join(timeout=1.0):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise TimeoutError("the depth,spatial unit ranks ran past 120 s")
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("check", sorted(unit.CHECKS))
def test_volume_part_on_a_d_block_over_all_rows(unit_errors, check):
    assert unit_errors[check] <= 1e-6, unit_errors


def test_every_combination_of_layouts_is_taken():
    for spec in ("views", "depth", "spatial", "views,depth",
                 "views,spatial", "depth,spatial", "views,depth,spatial"):
        assert par.layout_kinds(spec) == set(spec.split(","))
    pol = par.ShardingPolicy(par.Mesh(1, 2), shard_views=False,
                             shard_depth=True, shard_spatial=True)
    assert pol.shard_depth and pol.shard_spatial and not pol.shard_views
    assert pol.depth_slices(96, 4) == (slice(0, 48), slice(None))
    both = par.ShardingPolicy(par.Mesh(1, 2), shard_depth=True,
                              shard_spatial=True)
    assert both.depth_slices(96, 4) == (slice(None), slice(0, 48))
    assert not par.depth_sharded()
    with par.use_policy(pol):
        assert par.depth_sharded()
    # a grid of one model rank shards nothing
    one = par.ShardingPolicy(par.Mesh(1, 1), shard_depth=True,
                             shard_spatial=True)
    assert not (one.shard_depth or one.shard_spatial)


@pytest.fixture(scope="module")
def refs():
    """The single process's step on the gate's batch and on the 128-row
    batch of ``depth_spatial4``, on the CPU."""
    return E.references(load_npz_checkpoint(NPZ), EffiMVSConfig(),
                        E.train_batch(), "cpu", batches={
                            "depth_spatial4": E.train_batch(H=128)})


def _held(report, names, refs):
    for name in names:
        r = report[name]
        ref_loss = refs["steps"].get(name, refs["step"])[0]
        assert r["dloss"] <= E.LOSS_RTOL * (1 + abs(ref_loss)), (name, r)
        assert r["max_dparam"] <= E.PARAM_ATOL, (name, r)
        assert r["grad_worst_rel_l2"] < E.GRAD_REL, (name, r)


def test_two_ranks_depth_spatial_layouts_match_the_single_process(
        refs, tmp_path):
    names = ["depth_spatial", "views_depth_spatial"]
    report = E.spawn(2, names, refs, str(tmp_path), device="cpu",
                     timeout=120)
    _held(report, names, refs)


def test_four_ranks_depth_spatial_layouts_match_the_single_process(
        refs, tmp_path):
    names = ["depth_spatial4", "data_depth_spatial"]
    report = E.spawn(4, names, refs, str(tmp_path), device="cpu",
                     timeout=120, threads=1)
    _held(report, names, refs)


def test_gate_catches_gradients_averaged_for_the_depth_modules_only(
        refs, tmp_path):
    """Under ``depth,spatial`` the GRU, the context net and the FPN run on
    row blocks too: averaging only the depth layout's modules over the
    model group (``planted_sync``) leaves their gradients wrong, and the
    gate says so."""
    report = E.spawn(2, ["depth_spatial"], refs, str(tmp_path),
                     device="cpu", timeout=120, setup=unit.planted_sync,
                     check=False)
    r = report["depth_spatial"]
    assert r["grad_worst_rel_l2"] > 10 * E.GRAD_REL, r
    assert r["grad_worst_leaf"].split(".")[0] not in par.DEPTH_SHARDED, r
    with pytest.raises(AssertionError):
        E.check_step("depth_spatial", refs["step"][0], r)


@pytest.mark.parametrize("policy", ["depth,spatial", "views,depth,spatial"])
def test_train_cli_takes_the_layouts(policy):
    """In one process with two model ranks the run gets past the layout's
    checks to the grid's, which needs two processes."""
    from effi_mvs_plus_tpu_torch.cli import train
    with pytest.raises(SystemExit, match="needs 2 processes"):
        train.main(["--shard_policy", policy, "--model_parallel", "2",
                    "--device", "cpu"])


def test_train_cli_refuses_a_split_that_fails_d_or_h():
    """A split must pass both checks: every stage's D (stage 1 in blocks
    of 4 planes) and the image rows (blocks of 32), the first failing one
    named."""
    from effi_mvs_plus_tpu_torch.cli import train
    with pytest.raises(SystemExit, match="stage 1: .*GSPMD pads"):
        train.main(["--shard_policy", "depth,spatial", "--model_parallel",
                    "8", "--device", "cpu"])
    args = train.build_parser("blend_finetune").parse_args(
        ["--model_parallel", "4", "--shard_policy", "depth,spatial"])
    train._refuse_unported(args)
    train._refuse_row_split(args, _Rows(128))
    with pytest.raises(SystemExit, match="64 image rows .* 4 model ranks"):
        train._refuse_row_split(args, _Rows(64))


@pytest.mark.parametrize("policy", ["depth,spatial", "views,depth,spatial"])
def test_train_cli_depth_spatial_in_two_ranks(tmp_path, policy):
    """``--mode finetune --model_parallel 2 --shard_policy depth,spatial``
    (and ``views,depth,spatial``) in two processes with torchrun's
    environment: each rank holds 32 of the 64 image rows of the GRU's
    activations and 48 of the 96 stage-1 hypotheses; rank 0 alone writes
    the checkpoint."""
    root = str(tmp_path / "tree")
    listfile = _build_blend_tree(root)
    logdir = str(tmp_path / "run")
    outs = _two_ranks("train", [
        "--mode", "finetune", "--device", "cpu", "--trainpath", root,
        "--trainlist", listfile, "--testlist", listfile, "--logdir", logdir,
        "--loadckpt", NPZ, "--batch_size", "1", "--model_parallel", "2",
        "--shard_policy", policy, "--trainviews", "3",
        "--testviews", "3", "--num_workers", "1", "--epochs", "1",
        "--summary_freq", "1"])
    assert "saved" in outs[0] and "saved" not in outs[1]
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and all(math.isfinite(v) for v in losses)
    assert any("eval/loss" in r for r in rows)
