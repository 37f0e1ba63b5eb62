"""Spatial (image-row) sharding (``--shard_policy spatial`` and
``views,spatial``) on the CPU, in gloo ranks.

* The collectives and layers of a row block, in two spawned ranks
  (``tests/_torch_rows_rank.py``) on a 96-row image split 32 + 64: the
  row halo and the gather along H, forward and backward; train-mode 2-D
  and 3-D conv + BN (+ ReLU) blocks at stride 1, at stride 2, at the FPN's
  5x5 stride-2 level, 1x1 and 7x7, and the stride-2 and (1,2,2)
  transposes, each on its block against the whole tensor's op sliced, to
  1e-6 relative; ``convex_upsample``, the ConvGRU (plain version) and the
  plain warp with a row offset and its autograd (the warp's forward
  bitwise the whole image's rows); the FPN in train mode and in eval mode
  through the stem chain's plain version with chain-deep halos;
  ``CostRegNet`` and ``CSPBlock`` in eval mode with their fused 3-D
  layers (plain version), each layer with its halo rows.
* The equivalence gate (``parallel/equivalence.py``) of the spatial
  layouts against the single process (``model_dtu.npz``): ``spatial``,
  ``views_spatial``, the uneven ``spatial_uneven`` (96 rows: stage 1
  4 + 8) and the row-sharded engine in two ranks, ``data_spatial`` and
  ``spatial4`` (128 rows) in four, at the JAX gate's bounds (|Δloss| <=
  1e-4 (1 + |loss|), max |Δ| <= 2.5e-3 after one AdamW step) with every
  gradient leaf within rel-l2 5e-2, the engine's maps within the fp32 map
  tolerance.
* The train CLI: ``--model_parallel 2 --shard_policy spatial`` fine-tuning
  in two ranks, and a split that leaves a rank no rows refused.
* The K1/K3 C entry points take the arguments ``ops/_kernels.py``
  declares (no compiler here: the declarations are parsed)."""

import json
import math
import os
import re

import pytest
import torch
import torch.multiprocessing as mp

import _torch_rows_rank as unit
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
from effi_mvs_plus_tpu_torch.ops import _kernels
from effi_mvs_plus_tpu_torch.parallel import equivalence as E
from effi_mvs_plus_tpu_torch.parallel import mesh as par

from test_torch_blend import NPZ, _build_blend_tree
from test_torch_parallel import _two_ranks

# relative bound of each unit check: 1e-6, an fp32 sum in another order;
# the FPN in train mode chains eleven conv + BN layers, each normalised by
# statistics summed in another order (the blocks' sums, then the group's),
# and its stage maps carry that ten times over
BOUNDS = {name: 1e-6 for name in unit.CHECKS}
BOUNDS["fpn_train"] = 1e-5


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
    """Every check of ``_torch_rows_rank.CHECKS`` in one spawn of two
    ranks: its worst relative error over the ranks."""
    out = str(tmp_path_factory.mktemp("row_units") / "errors.json")
    ctx = mp.start_processes(unit.main, args=(2, E.free_port(), out),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(120):
        if ctx.join(timeout=1.0):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise TimeoutError("the row unit ranks ran past 120 s")
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("check", sorted(unit.CHECKS))
def test_row_block_op_matches_the_whole_tensor(unit_errors, check):
    assert unit_errors[check] <= BOUNDS[check], unit_errors


def test_warp_of_a_row_block_is_the_whole_images_rows(unit_errors):
    """The plain warp with a row offset forms each ray from the pixel's
    row in the whole image, so a block's correlations are the whole
    image's rows bit for bit."""
    assert unit_errors["warp_row_offset_max_abs"] == 0.0, unit_errors


def test_row_blocks_and_layouts():
    # T&T's 1056 rows: stage 1 has 132 rows, 64 + 68 over two ranks
    assert par.row_blocks_of(1056, 2) == [(0, 512), (512, 1056)]
    assert par.row_blocks_of(96, 2) == [(0, 32), (32, 96)]
    assert par.row_blocks_of(128, 4) == [(0, 32), (32, 64), (64, 96),
                                         (96, 128)]
    assert par.row_blocks_of(576, 2) == [(0, 288), (288, 576)]
    assert par.row_split_error(64, 2) is None
    assert "GSPMD pads" in par.row_split_error(64, 4)
    assert "GSPMD pads" in par.row_split_error(80, 2)
    with pytest.raises(ValueError, match="do not give each of 3"):
        par.row_blocks_of(64, 3)
    assert par.layout_kinds("spatial") == {"spatial"}
    assert par.layout_kinds("views,spatial") == {"views", "spatial"}
    for spec in ("depth,spatial", "views,depth,spatial"):
        assert par.layout_kinds(spec) == set(spec.split(","))
    both = par.ShardingPolicy(par.Mesh(1, 2), shard_depth=True,
                              shard_spatial=True)
    assert both.shard_depth and both.shard_spatial
    pol = par.ShardingPolicy(par.Mesh(1, 2), shard_views=False,
                             shard_spatial=True)
    assert pol.shard_spatial and not pol.shard_views
    assert not par.ShardingPolicy(par.Mesh(1, 1),
                                  shard_spatial=True).shard_spatial


def test_row_hooks_are_identities_without_a_policy():
    x = torch.ones(2, 8, 3)
    with par.image_rows(64) as rows, par.row_blocks():
        assert rows == (0, 64)
        assert par.run_blocked(lambda t: t, x, taps=5, clip=True) is x
        assert par.row_slice(8) == slice(None)
        (y,) = par.gather_rows(x, axis=1)
        assert y is x
        assert par.block_count(48, 8) == 48


def test_kernel_signatures_match_the_c_entry_points():
    """Each ``extern "C"`` entry point of csrc/*.cu takes, in order, the
    argument types its ctypes declaration passes (a pointer, an int, a
    long long or a float each): a mismatch would cut or shift arguments on
    the card only."""
    kinds = {"void*": _kernels._P, "int": _kernels._I,
             "longlong": _kernels._L, "float": _kernels._F}
    found = {}
    for name in _kernels.SOURCES:
        src = (_kernels.CSRC / name).read_text()
        for fn, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = []
            for p in params.split(","):
                typ = re.sub(r"\s*\w+$", "", p.strip())   # drop the name
                types.append(kinds[re.sub(r"\bconst\b|\s", "", typ)])
            found[fn] = types
    assert found == _kernels.SIGNATURES


@pytest.fixture(scope="module")
def refs():
    """The single process's step on the gate's batch and, for the layouts
    of ``E.ROW_HEIGHTS``, on a batch of their height, and the engine's
    maps, on the CPU."""
    batch = E.train_batch()
    request = {k: batch[k] for k in ("imgs", "proj_matrices",
                                     "depth_values")}
    return E.references(load_npz_checkpoint(NPZ), EffiMVSConfig(), batch,
                        "cpu", request, batches={
                            k: E.train_batch(H=h)
                            for k, h in E.ROW_HEIGHTS.items()})


def _held(report, names, refs):
    for name in names:
        r = report[name]
        ref_loss = refs["steps"].get(name, refs["step"])[0]
        assert r["dloss"] <= E.LOSS_RTOL * (1 + abs(ref_loss)), (name, r)
        assert r["max_dparam"] <= E.PARAM_ATOL, (name, r)
        assert r["grad_worst_rel_l2"] < E.GRAD_REL, (name, r)


def test_two_ranks_spatial_layouts_match_the_single_process(refs, tmp_path):
    names = ["spatial", "views_spatial", "spatial_uneven"]
    report = E.spawn(2, names + ["engine_spatial"], refs, str(tmp_path),
                     device="cpu", timeout=120)
    _held(report, names, refs)
    assert report["engine_spatial"]["depth_err_over_tolerance"] < 1


def test_four_ranks_spatial_layouts_match_the_single_process(refs, tmp_path):
    report = E.spawn(4, ["data_spatial", "spatial4"], refs, str(tmp_path),
                     device="cpu", timeout=120, threads=1)
    _held(report, ("data_spatial", "spatial4"), refs)


class _Rows:
    """A dataset stub whose samples have images of ``H`` rows."""

    def __init__(self, H):
        self.H = H

    def __getitem__(self, i):
        return {"imgs": torch.zeros(3, self.H, 96, 3).numpy()}


def test_train_cli_refuses_a_row_split_that_leaves_a_rank_no_rows():
    from effi_mvs_plus_tpu_torch.cli import train
    args = train.build_parser("blend_finetune").parse_args(
        ["--model_parallel", "4", "--shard_policy", "views,spatial"])
    train._refuse_row_split(args, _Rows(128))
    with pytest.raises(SystemExit, match="64 image rows .* 4 model ranks"):
        train._refuse_row_split(args, _Rows(128), _Rows(64))
    args.shard_policy = "views"
    train._refuse_row_split(args, _Rows(64))


def test_train_cli_spatial_in_two_ranks(tmp_path):
    """``--mode finetune --model_parallel 2 --shard_policy spatial`` in
    two processes with torchrun's environment: each rank holds 32 of the
    64 image rows; rank 0 alone writes the checkpoint."""
    root = str(tmp_path / "tree")
    listfile = _build_blend_tree(root)
    logdir = str(tmp_path / "run")
    outs = _two_ranks("train", [
        "--mode", "finetune", "--device", "cpu", "--trainpath", root,
        "--trainlist", listfile, "--testlist", listfile, "--logdir", logdir,
        "--loadckpt", NPZ, "--batch_size", "1", "--model_parallel", "2",
        "--shard_policy", "spatial", "--trainviews", "3", "--testviews",
        "3", "--num_workers", "1", "--epochs", "1", "--summary_freq", "1"])
    assert "saved" in outs[0] and "saved" not in outs[1]
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and all(math.isfinite(v) for v in losses)
    assert any("eval/loss" in r for r in rows)
