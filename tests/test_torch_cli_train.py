"""The port's DTU training reader and train CLI on a tiny synthetic
DTU-training tree, on the CPU: the reader's samples equal the JAX
reader's for the same seed (its resize included), and
``cli/train.py --mode train --device cpu`` runs an epoch, writes a
checkpoint and the metrics JSONL, resumes from the checkpoint, and starts
from a shipped npz or a port checkpoint; what the CLI refuses, it refuses
with its reason, and the layouts and the device cache it takes."""

import functools
import json
import os
import random

import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu.data import datasets as jds
from effi_mvs_plus_tpu_torch.cli import train as cli
from effi_mvs_plus_tpu_torch.data import datasets as tds
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
from effi_mvs_plus_tpu_torch.train import trainer as T
from effi_mvs_plus_tpu_torch.utils import logging as tlog


def _build_tiny_dtu_tree(root, n_views=3, img_wh=(160, 128)):
    """DTU-training layout at toy resolution (images img_wh, GT at 2x
    crop source size so the half+crop pipeline is exercised)."""
    from PIL import Image
    from effi_mvs_plus_tpu.data import cams as camio
    from effi_mvs_plus_tpu.data.pfm import save_pfm

    W, H = img_wh
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "Cameras", "train"), exist_ok=True)
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write(f"{n_views}\n")
        for v in range(n_views):
            srcs = [s for s in range(n_views) if s != v]
            f.write(f"{v}\n{len(srcs)} "
                    + " ".join(f"{s} 10.0" for s in srcs) + "\n")

    K = np.array([[90.0, 0, W / 8], [0, 90.0, H / 8], [0, 0, 1]],
                 np.float32)
    for v in range(n_views):
        E = np.eye(4, dtype=np.float32)
        E[:3, 3] = [10.0 * v, 0, 0]
        camio.write_cam_file(
            os.path.join(root, "Cameras", "train", f"{v:08d}_cam.txt"),
            E, K, [425.0, 2.5])

    scan = "scan1"
    img_dir = os.path.join(root, "Rectified", f"{scan}_train")
    dep_dir = os.path.join(root, "Depths_raw", scan)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(dep_dir, exist_ok=True)
    for v in range(n_views):
        for light in range(7):
            img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            Image.fromarray(img).save(
                os.path.join(img_dir, f"rect_{v + 1:03d}_{light}_r5000.png"))
        depth = rng.uniform(430, 930, (H * 2 + 64, W * 2 + 64)).astype(
            np.float32)
        save_pfm(os.path.join(dep_dir, f"depth_map_{v:04d}.pfm"), depth)
        mask = np.full((H * 2 + 64, W * 2 + 64), 255, np.uint8)
        Image.fromarray(mask).save(
            os.path.join(dep_dir, f"depth_visual_{v:04d}.png"))

    listfile = os.path.join(root, "list.txt")
    with open(listfile, "w") as f:
        f.write("scan1\n")
    return listfile


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    return root, _build_tiny_dtu_tree(root)


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("mode,crop", [("train", (160, 128)),
                                       ("train", (96, 64)),
                                       ("test", (128, 96))])
def test_dtu_train_dataset_matches_jax_reader(tree, mode, crop):
    root, listfile = tree
    port = tds.DTUTrainDataset(root, listfile, mode, 3,
                               rng=random.Random(7), crop_wh=crop)
    ref = jds.DTUTrainDataset(root, listfile, mode, 3,
                              rng=random.Random(7), crop_wh=crop)
    assert len(port) == len(ref) == (21 if mode == "train" else 3)
    for idx in (0, len(ref) // 2, len(ref) - 1):
        _assert_same(port[idx], ref[idx])


def test_resize_nearest_matches_jax_reader():
    rng = np.random.default_rng(1)
    for shape, wh in (((320, 384), (192, 160)), ((101, 77), (9, 12)),
                      ((64, 96, 3), (12, 8)), ((50, 60), (60, 50))):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        np.testing.assert_array_equal(
            tds._resize_nearest(img, wh), jds._resize(img, wh, nearest=True))


def test_train_cli_epoch_checkpoint_resume(tree, tmp_path, monkeypatch):
    # tensorboard's import takes seconds here; the JSONL is the record
    monkeypatch.setattr(tlog.MetricsWriter, "__init__",
                        functools.partialmethod(tlog.MetricsWriter.__init__,
                                                tensorboard=False))
    root, listfile = tree
    logdir = str(tmp_path / "run")
    argv = ["--mode", "train", "--device", "cpu", "--trainpath", root,
            "--trainlist", listfile, "--testlist", listfile,
            "--logdir", logdir, "--crop_wh", "96,64", "--epochs", "1",
            "--batch_size", "7", "--trainviews", "3", "--testviews", "3",
            "--num_workers", "2", "--summary_freq", "1"]
    cli.main(argv)
    ckpt = os.path.join(logdir, "model_000000.ckpt")
    assert T.latest_checkpoint(logdir) == ckpt
    payload = T.load_checkpoint(ckpt)
    assert payload["epoch"] == 0
    assert len(payload["model"]) == 563          # the reference's keys
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    train_rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) for r in train_rows)
    assert any("eval/thres20mm_abserror" in r for r in rows)

    # resume: epoch 1 continues from the checkpoint, optimizer state and
    # schedule included
    cli.main(argv + ["--epochs", "2", "--resume"])
    assert T.latest_checkpoint(logdir).endswith("model_000001.ckpt")
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    assert any(r.get("event") == "resume" and r["epoch"] == 1 for r in rows)
    assert [r["step"] for r in rows if "train/loss" in r] == [1, 2, 3,
                                                              4, 5, 6]
    after = T.load_checkpoint(T.latest_checkpoint(logdir))
    assert after["optimizer"]["state"][0]["step"] == 6
    assert after["scheduler"]["last_epoch"] == 6
    moved = [not torch.equal(after["model"][k], payload["model"][k])
             for k in payload["model"] if k.endswith("weight")]
    assert any(moved)


def test_train_cli_loadckpt(tree, tmp_path, monkeypatch):
    """--loadckpt starts from the shipped npz, or from a port checkpoint:
    one epoch (3 AdamW steps) then moves each weight by at most 3 lr."""
    monkeypatch.setattr(tlog.MetricsWriter, "__init__",
                        functools.partialmethod(tlog.MetricsWriter.__init__,
                                                tensorboard=False))
    root, listfile = tree
    npz = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "checkpoints", "model_dtu.npz")
    common = ["--device", "cpu", "--trainpath", root, "--trainlist",
              listfile, "--testlist", listfile, "--crop_wh", "96,64",
              "--epochs", "1", "--batch_size", "7", "--trainviews", "3",
              "--testviews", "3", "--num_workers", "2", "--lr", "1e-3"]
    start = load_npz_checkpoint(npz)
    for init in (npz, os.path.join(str(tmp_path / "a"),
                                   "model_000000.ckpt")):
        logdir = str(tmp_path / ("a" if init == npz else "b"))
        cli.main(common + ["--loadckpt", init, "--logdir", logdir])
        got = T.load_checkpoint(os.path.join(logdir,
                                             "model_000000.ckpt"))["model"]
        moved = max(float((got[k] - start[k]).abs().max())
                    for k in start if k.endswith("weight"))
        assert 0 < moved <= 3 * 1e-3 * 1.01, moved
        start = got


# what stays refused, and why: fine-tuning needs weights to start from;
# a grid needs as many processes as it has ranks.  The layouts and the
# device cache are taken: with two model ranks in one process the run
# goes on to the grid's check, which refuses them
REFUSED = {"--mode": "requires --loadckpt", "--shard_policy": None,
           "--device_cache": None,
           "--data_parallel": "needs 2 processes",
           "--model_parallel": "needs 2 processes"}


@pytest.mark.parametrize("flag", [["--mode", "finetune"],
                                  ["--shard_policy", "depth,spatial"],
                                  ["--shard_policy", "spatial"],
                                  ["--device_cache"],
                                  ["--data_parallel", "2"],
                                  ["--model_parallel", "2"]])
def test_unported_options_are_refused(flag):
    why = REFUSED[flag[0]] or "needs 2 processes"
    if REFUSED[flag[0]] is None:
        flag = flag + ["--model_parallel", "2"]
    with pytest.raises(SystemExit, match=why):
        cli.main(flag + ["--device", "cpu"])


def test_train_cli_without_gpu_raises(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    root, listfile = tree
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--trainpath", root, "--trainlist", listfile,
                  "--testlist", listfile, "--logdir", str(tmp_path)])
