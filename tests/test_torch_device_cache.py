"""The port's device cache (``data/device_cache.py``) on the CPU, on the
tiny synthetic DTU tree of ``tests/test_device_cache.py`` (2 scans, 6
refs, 7 lights aliased by symlinks, 160x128):

* train mode, shuffled, seed 1: every batch of two epochs equals the JAX
  ``DeviceCacheLoader``'s (run on JAX's CPU) bit for bit, the order and
  the source views drawn alike;
* test mode: the batches equal the port's ``Loader``'s after
  ``batch_to_device`` within the JAX test's 1e-6 (the images within one
  ulp: the JAX cache, and so the port's, rounds x / 255 as x times the
  reciprocal; every other leaf and each image's bytes bit for bit), and
  pass through ``batch_to_device`` without a copy;
* the budget guard refuses before any upload, and a BlendedMVS set is
  refused with its reason;
* two gloo CPU ranks (data 2 x model 1) through the train CLI's
  ``device_cache_loaders``: their rows make up the single process's
  batches;
* ``cli/train.py --device_cache --device cpu`` trains an epoch, and the
  CLI refuses the cache across hosts, as the JAX CLI does."""

import json
import math
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_cache_rank
from effi_mvs_plus_tpu_torch.data.datasets import DTUTrainDataset
from effi_mvs_plus_tpu_torch.data.device_cache import DeviceCacheLoader
from effi_mvs_plus_tpu_torch.data.loader import Loader
from effi_mvs_plus_tpu_torch.parallel import equivalence as E
from effi_mvs_plus_tpu_torch.train import trainer as T

from test_device_cache import tiny_tree  # noqa: F401  (the fixture)

NVIEWS, CROP = 4, (160, 128)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's torch work (the suite runs
    several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _dataset(tiny_tree, mode):
    root, lst = tiny_tree
    return DTUTrainDataset(root, lst, mode, NVIEWS, crop_wh=CROP)


def test_train_mode_batches_equal_the_jax_cache(tiny_tree):
    """Two shuffled epochs at seed 1, batch 4: the same samples, sources
    and values bit for bit as the JAX cache's."""
    from effi_mvs_plus_tpu.data.datasets import DTUTrainDataset as JDs
    from effi_mvs_plus_tpu.data.device_cache import DeviceCacheLoader as JDc
    root, lst = tiny_tree
    want = JDc(JDs(root, lst, "train", NVIEWS, crop_wh=CROP), 4,
               shuffle=True, seed=1, drop_last=True)
    got = DeviceCacheLoader(_dataset(tiny_tree, "train"), 4, shuffle=True,
                            seed=1, drop_last=True, device="cpu")
    assert len(got) == len(want) == 84 // 4
    assert got.nbytes() == want.nbytes()
    for _ in range(2):
        n = 0
        for b_want, b_got in zip(want, got):
            for (path, w), (gpath, g) in zip(_leaves(b_want),
                                             _leaves(b_got)):
                assert path == gpath
                w = np.asarray(w)
                assert g.dtype == torch.float32 and g.device.type == "cpu"
                assert g.shape == w.shape, path
                assert np.array_equal(g.numpy(), w), path
            n += 1
        assert n == len(got)


def test_test_mode_matches_the_loader(tiny_tree):
    """Eval batches against the streaming reader's after
    ``batch_to_device``, within the JAX test's 1e-6; already on the
    device, they pass through ``batch_to_device`` as they are."""
    ds = _dataset(tiny_tree, "test")
    ld = Loader(ds, 3, shuffle=False, drop_last=True, num_workers=2)
    dc = DeviceCacheLoader(ds, 3, shuffle=False, drop_last=True,
                           device="cpu")
    assert len(ld) == len(dc) == 4
    for b_ref, b_dc in zip(ld, dc):
        b_ref.pop("filename")
        want = dict(_leaves(T.batch_to_device(b_ref, "cpu")))
        got = dict(_leaves(b_dc))
        assert sorted(want) == sorted(got)
        for path, w in want.items():
            assert got[path].shape == w.shape, path
            assert float((got[path] - w).abs().max()) < 1e-6, path
            if path == "/imgs":
                assert torch.equal(torch.round(got[path] * 255),
                                   torch.round(w * 255))
                assert float((got[path] - w).abs().max()) <= 2 ** -24
            else:
                assert torch.equal(got[path], w), path
        moved = dict(_leaves(T.batch_to_device(b_dc, "cpu")))
        assert all(moved[p] is t for p, t in got.items())


def test_budget_guard_refuses_before_any_upload(tiny_tree, monkeypatch):
    ds = _dataset(tiny_tree, "test")
    monkeypatch.setattr(torch.Tensor, "to", lambda *a, **k: pytest.fail(
        "uploaded before the size check"))
    with pytest.raises(ValueError, match="device cache"):
        DeviceCacheLoader(ds, 2, budget_bytes=1000, device="cpu")


def test_blendedmvs_is_refused_with_its_reason(tmp_path):
    from effi_mvs_plus_tpu_torch.data.datasets import BlendedMVSDataset
    from test_torch_blend import _build_blend_tree
    root = str(tmp_path / "blend")
    listfile = _build_blend_tree(root)
    ds = BlendedMVSDataset(root, listfile, "train", 3)
    with pytest.raises(ValueError, match="DTUTrainDataset's layout .*"
                                         "BlendedMVSDataset"):
        DeviceCacheLoader(ds, 2, device="cpu")


def test_two_ranks_rows_make_up_the_batch(tiny_tree, tmp_path):
    """Each data rank of a 2 x 1 grid walks the global batches of 4 and
    keeps its 2 rows; together they are the single process's batches."""
    root, lst = tiny_tree
    kw = {"crop_wh": CROP}
    ds_args = {"train": (root, lst, "train", NVIEWS),
               "test": (root, lst, "test", NVIEWS), "kw": kw}
    out = str(tmp_path / "batches")
    ctx = mp.start_processes(_torch_cache_rank.main,
                             args=(2, E.free_port(), ds_args, 4, out),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(120):
        if ctx.join(timeout=1.0):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise TimeoutError("the cache ranks ran past 120 s")
    ranks = [torch.load(f"{out}.{r}.pt") for r in range(2)]
    single = {"train": DeviceCacheLoader(
        DTUTrainDataset(root, lst, "train", NVIEWS, **kw), 4, shuffle=True,
        seed=1, drop_last=True, device="cpu"),
        "test": DeviceCacheLoader(
            DTUTrainDataset(root, lst, "test", NVIEWS, **kw), 4,
            drop_last=True, device="cpu")}
    for split, loader in single.items():
        batches = list(loader)
        assert len(batches) == len(ranks[0][split]) == len(ranks[1][split])
        for i, b in enumerate(batches):
            r0, r1 = (dict(_leaves(r[split][i])) for r in ranks)
            for path, want in _leaves(b):
                assert r0[path].shape[0] == 2, path
                assert torch.equal(torch.cat([r0[path], r1[path]]), want)


def test_train_cli_device_cache_trains_an_epoch(tmp_path):
    """``--device_cache --device cpu``: one epoch of the DTU training tree
    of ``tests/test_torch_cli_train.py`` fed by the cache, a finite loss,
    the cache's size printed, a checkpoint and an eval."""
    from effi_mvs_plus_tpu_torch.cli import train as cli
    from test_torch_cli_train import _build_tiny_dtu_tree
    import contextlib
    import io
    root = str(tmp_path / "tree")
    listfile = _build_tiny_dtu_tree(root)
    logdir = str(tmp_path / "run")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--mode", "train", "--device", "cpu", "--device_cache",
                  "--trainpath", root, "--trainlist", listfile,
                  "--testlist", listfile, "--logdir", logdir,
                  "--crop_wh", "96,64", "--epochs", "1", "--batch_size",
                  "7", "--trainviews", "3", "--testviews", "3",
                  "--summary_freq", "1"])
    out = buf.getvalue()
    assert "device cache: " in out and "GB eval" in out, out
    assert os.path.exists(os.path.join(logdir, "model_000000.ckpt"))
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert any("eval/loss" in r for r in rows)


def test_train_cli_refuses_the_cache_across_hosts(monkeypatch):
    """As the JAX CLI asserts one process, the port takes the cache on
    one host only: eight processes of which torchrun puts four on each
    host are refused with the reason, before any dataset is read."""
    from effi_mvs_plus_tpu_torch import parallel
    from effi_mvs_plus_tpu_torch.cli import train as cli
    from effi_mvs_plus_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.hosts() == parallel.hosts() == 2
    monkeypatch.setattr(parallel, "world_size", lambda: 8)
    args = cli.build_parser().parse_args(["--device_cache"])
    with pytest.raises(SystemExit, match="8 processes run on 2 hosts"):
        cli.device_cache_loaders(args, None, None, 4, None, "cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert distributed.hosts() == 1
