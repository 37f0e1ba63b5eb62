"""BlendedMVS fine-tuning and the train CLI's test and profile modes in the
port, against the JAX package on the CPU, on a small synthetic BlendedMVS
tree (the layout of tests/test_eval_blend_reader_parity.py at 96x64).

The reader must equal JAX's array for array; the profile, the registry
names and ``register_dataset`` must match; one ``--mode finetune`` step
from ``checkpoints/model_dtu.npz`` must give JAX's loss on the same first
batch within test_torch_train.py's train-step tolerance (rtol 2e-4, with
dropout off on both sides: the two random streams cannot match);
``run_test`` must give JAX's eval suite (the losses and the mean absolute
error rtol 2e-4, the threshold and band shares atol 2e-3: a pixel whose
error sits at a threshold may count on either side); ``run_profile``
times steps and writes its trace.  The torch-only tests run first: after
XLA has run, torch's CPU kernels in the same process run about twice as
slow."""

import functools
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effi_mvs_plus_tpu import config as jconfig
from effi_mvs_plus_tpu import nn as jnn
from effi_mvs_plus_tpu.cli import train as jcli
from effi_mvs_plus_tpu.data import datasets as jds
from effi_mvs_plus_tpu.data.loader import Loader as JaxLoader
from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load_npz
from effi_mvs_plus_tpu.models import forward as jax_forward
from effi_mvs_plus_tpu.train import loss as jloss
from effi_mvs_plus_tpu_torch import config as tconfig
from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.cli import train as cli
from effi_mvs_plus_tpu_torch.data import datasets as tds
from effi_mvs_plus_tpu_torch.data import find_dataset, register_dataset
from effi_mvs_plus_tpu_torch.utils import logging as tlog

from test_torch_cli_train import _assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "checkpoints", "model_dtu.npz")
SCAN = "5a0271884e62597cdee0d0eb"
N_VIEWS = 9
N_REFS = 2           # refs 0-1 keep 8 sources; refs 2-8 keep 5 (dropped)


def _build_blend_tree(root, wh=(96, 64)):
    from PIL import Image
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.pfm import save_pfm

    rng = np.random.default_rng(5)
    base = os.path.join(root, SCAN)
    for d in ("cams", "blended_images", "rendered_depth_maps"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    with open(os.path.join(base, "cams", "pair.txt"), "w") as f:
        f.write(f"{N_VIEWS}\n")
        for v in range(N_VIEWS):
            srcs = [s for s in range(N_VIEWS) if s != v]
            rng.shuffle(srcs)
            if v >= N_REFS:
                srcs = srcs[:5]
            f.write(f"{v}\n{len(srcs)} "
                    + " ".join(f"{s} {100.0 - i}" for i, s in enumerate(srcs))
                    + "\n")
    w, h = wh
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]],
                 np.float32)
    for v in range(N_VIEWS):
        E = np.eye(4, dtype=np.float32)
        E[:3, 3] = [0.3 * v, 0.05 * v, 0]
        camio.write_cam_file(os.path.join(base, "cams", f"{v:08d}_cam.txt"),
                             E, K, [2.5, 0.05, 128.0, 12.0])
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(base, "blended_images", f"{v:08d}.jpg"))
        save_pfm(os.path.join(base, "rendered_depth_maps", f"{v:08d}.pfm"),
                 rng.uniform(1.5, 14.0, (h, w)).astype(np.float32))
    listfile = os.path.join(root, "list.txt")
    with open(listfile, "w") as f:
        f.write(SCAN + "\n")
    return listfile



@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's torch work: the suite runs
    several workers on the host's cores, and torch's threads, when they
    outnumber the cores, slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blend"))
    return root, _build_blend_tree(root)


@pytest.fixture
def no_tensorboard(monkeypatch):
    # tensorboard's import takes seconds here; the JSONL is the record
    monkeypatch.setattr(tlog.MetricsWriter, "__init__",
                        functools.partialmethod(tlog.MetricsWriter.__init__,
                                                tensorboard=False))


@pytest.mark.parametrize("mode,disp_max_first", [("train", False),
                                                 ("finetune", False),
                                                 ("train", True),
                                                 ("finetune", True)])
def test_blend_reader_matches_jax_reader(tree, mode, disp_max_first):
    root, listfile = tree
    port = tds.BlendedMVSDataset(root, listfile, mode, 7, 96,
                                 disp_max_first, rng=random.Random(3))
    ref = jds.BlendedMVSDataset(root, listfile, mode, 7, 96,
                                disp_max_first, rng=random.Random(3))
    assert len(port) == len(ref) == N_REFS         # 5-source refs drop
    assert port.metas == ref.metas
    for idx in (0, 1, 0):                           # 0 twice: rng advances
        _assert_same(port[idx], ref[idx])
    # the default generator is random.Random(0) in both
    a = tds.BlendedMVSDataset(root, listfile, mode, 4)
    b = jds.BlendedMVSDataset(root, listfile, mode, 4)
    _assert_same(a[1], b[1])


def test_registry_and_register_dataset():
    for name in ("blend", "blendedmvs"):
        assert find_dataset(name) is tds.BlendedMVSDataset
    for name in ("tank", "tanks"):
        assert find_dataset(name) is tds.TanksDataset
    for name in ("dtu", "dtu_yao"):
        assert find_dataset(name) is tds.DTUTrainDataset
    with pytest.raises(ValueError, match="unknown dataset"):
        find_dataset("eth3d")

    class Mine:
        pass
    register_dataset("mine", Mine)
    try:
        assert find_dataset("mine") is Mine
    finally:
        from effi_mvs_plus_tpu_torch.data import registry
        registry._REGISTRY.pop("mine")


def test_blend_finetune_profile_matches_jax():
    import dataclasses
    got = tconfig.get_profile("blend_finetune")
    want = jconfig.get_profile("blend_finetune")
    assert dataclasses.asdict(got.data) == dataclasses.asdict(want.data)
    assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train)
    assert got.lists == want.lists
    for f in ("ndepths", "gru_iters", "CostNum", "hdim_stage"):
        assert getattr(got.model, f) == getattr(want.model, f), f
    for name in ("dtu_train", "dtu_eval", "tank_eval"):
        assert tconfig.get_profile(name).lists == \
            jconfig.get_profile(name).lists
    b = cli.build_parser("blend_finetune").parse_args(["--trainpath", "x"])
    assert (b.epochs, b.batch_size, b.lr) == (10, 8, 4e-4)
    assert (b.trainviews, b.dataset, b.ndepths) == (7, "blend", "96,8,8")
    # the profile's lists are the CLI's default scan lists
    assert (b.trainlist, b.testlist) == tuple(
        os.path.join(ROOT, f) for f in want.lists)
    assert all(os.path.isfile(f) for f in (b.trainlist, b.testlist))


def test_finetune_requires_loadckpt(tree):
    root, listfile = tree
    with pytest.raises(SystemExit, match="requires --loadckpt"):
        cli.main(["--mode", "finetune", "--device", "cpu", "--trainpath",
                  root, "--trainlist", listfile, "--testlist", listfile])


def test_profiling_defaults_to_the_card():
    """``Timer`` and ``profile_trace`` fence and trace the card unless told
    otherwise; on the CPU there is nothing to fence."""
    import inspect
    from effi_mvs_plus_tpu_torch.utils import profiling
    assert profiling.Timer(lambda: None).device == torch.device("cuda")
    sig = inspect.signature(profiling.profile_trace.__wrapped__)
    assert sig.parameters["device"].default == "cuda"
    assert profiling.Timer(lambda: None, warmup=0, iters=2,
                           device="cpu").measure() >= 0


def test_run_profile_writes_trace(tree, tmp_path, capsys):
    root, listfile = tree
    args = cli.build_parser().parse_args(
        ["--mode", "profile", "--device", "cpu", "--batch_size", "1",
         "--num_workers", "1", "--testviews", "3", "--logdir",
         str(tmp_path), "--dataset", "blend"])
    test_ds = tds.BlendedMVSDataset(root, listfile, "test", 3, 384)
    dt = cli.run_profile(args, cli.make_config(args), test_ds, "cpu")
    assert dt > 0
    assert "ms/step" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(str(tmp_path), "trace",
                                       "trace.json"))


def test_run_profile_trace_shows_the_program_spans(tree, tmp_path):
    """The profile's chrome trace holds the train step's spans
    (``utils/profiling.span``), nested as the step runs them."""
    import json
    root, listfile = tree
    args = cli.build_parser().parse_args(
        ["--mode", "profile", "--device", "cpu", "--batch_size", "1",
         "--num_workers", "1", "--testviews", "3", "--logdir",
         str(tmp_path), "--dataset", "blend"])
    test_ds = tds.BlendedMVSDataset(root, listfile, "test", 3, 384)
    cli.run_profile(args, cli.make_config(args), test_ds, "cpu")
    with open(os.path.join(str(tmp_path), "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith(("train.", "model."))}
    assert {"train.step", "train.upload", "train.forward", "train.backward",
            "train.optimizer", "model.features", "model.stage1",
            "model.stage2", "model.stage3", "model.gru_iter"} <= set(spans)
    step, fwd = spans["train.step"], spans["train.forward"]
    assert step["ts"] <= fwd["ts"] and \
        fwd["ts"] + fwd["dur"] <= step["ts"] + step["dur"]


def _common(root, listfile, logdir, views=3):
    return ["--device", "cpu", "--trainpath", root, "--trainlist", listfile,
            "--testlist", listfile, "--logdir", logdir, "--loadckpt", NPZ,
            "--batch_size", "2", "--trainviews", str(views),
            "--testviews", str(views), "--num_workers", "2", "--epochs", "1",
            "--summary_freq", "1"]


def test_finetune_step_matches_jax(tree, tmp_path, monkeypatch,
                                   no_tensorboard):
    """``--mode finetune`` picks the blend_finetune profile (96/8/8, the
    blend reader, seed 1); the loss its step logs equals the JAX package's
    train-mode loss (``train/trainer.py`` ``make_train_step``'s
    ``loss_fn``: the forward with BN batch statistics, then ``mvs_loss``)
    on the same batch, from the same weights."""
    monkeypatch.setattr(nn.ChannelDropout, "forward", lambda self, x: x)
    monkeypatch.setattr(jnn, "dropout", lambda x, rate, ctx: x)
    root, listfile = tree
    logdir = str(tmp_path / "ft")
    cli.main(["--mode", "finetune"] + _common(root, listfile, logdir))
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == N_REFS // 2
    assert os.path.exists(os.path.join(logdir, "model_000000.ckpt"))

    # the CLI's batch: the train reader shuffled by --seed 1
    ds = jds.BlendedMVSDataset(root, listfile, "train", 3, 384)
    batch = next(iter(JaxLoader(ds, 2, shuffle=True, drop_last=True,
                                seed=1, num_workers=1)))
    batch.pop("filename")
    cfg = jcli.make_config(cli.build_parser("blend_finetune").parse_args(
        ["--trainpath", "x"]))
    assert cfg.ndepths == (96, 8, 8)

    def loss_fn(p, b):
        ctx = jnn.Ctx(train=True, rng=jax.random.PRNGKey(0))
        out = jax_forward(p, b["imgs"], b["proj_matrices"],
                          b["depth_values"], cfg, ctx)
        return jloss.mvs_loss(out["depth"], b["depth"], b["mask"])[0]
    want = jax.jit(loss_fn)(jax_load_npz(NPZ),
                            jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(losses[0], float(want), rtol=2e-4)


def _jax_params(args, cfg, rng):
    return jax_load_npz(NPZ), 0, None


def test_run_test_matches_jax(tree, monkeypatch):
    root, listfile = tree
    argv = ["--mode", "test", "--device", "cpu", "--loadckpt", NPZ,
            "--batch_size", "2", "--num_workers", "1", "--testviews", "3",
            "--ndepths", "96,8,8", "--dataset", "blend"]
    args = cli.build_parser().parse_args(argv)
    test_ds = tds.BlendedMVSDataset(root, listfile, "test", 3, 384)
    got = cli.run_test(args, cli.make_config(args), test_ds, "cpu")

    monkeypatch.setattr(jcli, "load_initial_params", _jax_params)
    jargs = jcli.build_parser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")])
    want = jcli.run_test(jargs, jcli.make_config(jargs),
                         jax.random.PRNGKey(0),
                         jds.BlendedMVSDataset(root, listfile, "test", 3,
                                               384))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]), k
        if "thres" in k:
            np.testing.assert_allclose(got[k], want[k], atol=2e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       err_msg=k)

