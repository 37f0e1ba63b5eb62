"""Training CLI: ``--mode train|finetune|test|profile``.

The port of ``effi_mvs_plus_tpu/cli/train.py``: the same argument surface
and profiles, the train and eval epochs, per-epoch checkpoints
(``model_NNNNNN.ckpt``, ``train/trainer.py``), the metrics JSONL and
``--resume``.  Runs on ``--device`` (``cuda`` unless told otherwise).

* Checkpoints of the JAX package are taken as the JAX CLI takes them
  (``io.load_state_dict``, ``train/trainer.py``): ``--resume`` in a logdir
  the JAX CLI wrote continues its newest ``model_NNNNNN.ckpt`` at
  ``epoch + 1`` with the AdamW moments and the schedule's step
  (``optim.load_optax_state``); ``--loadckpt`` takes the weights alone of
  a shipped ``.npz``, a port or reference torch ``.ckpt`` or a JAX
  checkpoint.  An orbax directory is refused with its reason.

* ``--mode finetune`` selects the ``blend_finetune`` profile (BlendedMVS,
  96/8/8, 7 views, B=8, lr 4e-4) and needs ``--loadckpt``.
* ``--trainlist`` / ``--testlist`` default to the profile's scan lists
  under ``lists/`` (``lists/dtu``, ``lists/bld``).
* ``--mode test`` evaluates the weights on the eval split (``run_test``);
  ``--mode profile`` times training steps on one eval batch and writes a
  ``torch.profiler`` trace under ``<logdir>/trace`` (``run_profile``).
* Multi-process: one process per GPU, launched by ``torchrun`` (or any
  launcher that sets ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
  ``MASTER_PORT``).  The processes form a (data, model) grid
  (``--data_parallel`` x ``--model_parallel``, ``parallel/mesh.py``):
  ``--batch_size`` is the global batch, each data rank reads its own
  shard of the samples and takes ``batch_size / data`` of them a step,
  and with ``--model_parallel > 1`` the model ranks split the source
  views, the cost volume's hypotheses, the image rows, or any
  combination of them (``--shard_policy``, ``views,depth`` by default,
  as the JAX CLI's).  Checkpoints and the metrics JSONL are written by
  rank 0.
* ``--device_cache`` holds the DTU training and eval sets on the device
  and assembles the batches there (``data/device_cache.py``); on a grid
  of ranks each rank builds the cache on its own GPU, walks the same
  global batches and keeps its data rank's rows of each.

Refused with an error, before any work: a depth split of ``--ndepths``
over ``--model_parallel`` into blocks the 3-D U-Net's halos cannot serve
(``parallel.depth_split_error``), a row split of the images that leaves a
model rank no rows (``parallel.row_split_error``), and
``--device_cache`` for a dataset other than DTU training or for
processes on several hosts (the JAX package's cache holds neither).

Usage:
  python -m effi_mvs_plus_tpu_torch.cli.train --mode train \
      --trainpath DTU_TRAIN_ROOT --trainlist lists/dtu/train.txt \
      --testlist lists/dtu/test.txt --logdir ckpts --epochs 16 \
      --batch_size 4 --lr 1e-3
  torchrun --nproc_per_node 4 -m effi_mvs_plus_tpu_torch.cli.train \
      --mode finetune --trainpath BLENDEDMVS_ROOT \
      --trainlist lists/bld/training_list.txt \
      --testlist lists/bld/validation_list.txt \
      --loadckpt checkpoints/model_dtu.npz --data_parallel 2 \
      --model_parallel 2
  torchrun --nproc_per_node 2 -m effi_mvs_plus_tpu_torch.cli.train \
      --mode finetune --trainpath BLENDEDMVS_ROOT \
      --loadckpt checkpoints/model_dtu.npz --model_parallel 2 \
      --shard_policy spatial
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import torch

def build_parser(profile_name="dtu_train"):
    from effi_mvs_plus_tpu_torch.config import (apply_profile_defaults,
                                                get_profile)
    p = argparse.ArgumentParser("effi-mvs-plus-tpu-torch train")
    p.add_argument("--profile", default=profile_name,
                   help="named preset from config.PROFILES")
    p.add_argument("--mode", default="train",
                   choices=["train", "finetune", "test", "profile"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    p.add_argument("--dataset")
    p.add_argument("--trainpath", required=False)
    p.add_argument("--testpath", default=None)
    p.add_argument("--trainlist", required=False)
    p.add_argument("--testlist", required=False)
    p.add_argument("--epochs", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--wd", type=float)
    p.add_argument("--lossrate", type=float)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--interval_scale", type=float)
    p.add_argument("--trainviews", type=int)
    p.add_argument("--testviews", type=int)
    p.add_argument("--ndepths", type=str)
    p.add_argument("--GRUiters", type=str, default="3,3,3")
    p.add_argument("--CostNum", type=int)
    p.add_argument("--logdir", default="./checkpoints/run")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--loadckpt", default=None,
                   help="init weights from a shipped .npz, a port or "
                        "reference torch .ckpt, or a JAX train "
                        "model_NNNNNN.ckpt")
    p.add_argument("--summary_freq", type=int)
    p.add_argument("--save_freq", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--num_workers", type=int)
    p.add_argument("--crop_wh", default=None,
                   help="DTU crop size 'W,H' (default 640,512); smaller "
                        "values centre-crop the images and shift the "
                        "principal point to match")
    p.add_argument("--device_cache", action="store_true",
                   help="hold the DTU train/eval sets on the device and "
                        "assemble batches there (single host)")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="ranks on the data axis (default: all of them over "
                        "--model_parallel)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks on the model axis, which split the source "
                        "views and/or the cost volume's hypotheses")
    p.add_argument("--shard_policy", default="views,depth",
                   help="comma list of model-axis layouts: views (FPN, "
                        "per-view warps and PixelwiseNet sharded, the view "
                        "sums all-reduced), depth (each rank a block of "
                        "every stage's hypotheses through the 3-D U-Net "
                        "and the CSP blocks, with halos along D), spatial "
                        "(each rank a block of image rows of every "
                        "activation, with halos along H); with several, "
                        "each tensor along one of them")
    profile = get_profile(profile_name)
    apply_profile_defaults(p, profile)
    if len(profile.lists) == 2:   # the repo's scan lists: train, then eval
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        p.set_defaults(trainlist=os.path.join(repo, profile.lists[0]),
                       testlist=os.path.join(repo, profile.lists[1]))
    return p


def _refuse_unported(args):
    """Refuse a layout or a split the port does not take, with the reason,
    before any work."""
    from effi_mvs_plus_tpu_torch.models.effi_mvs import stage_depth_multiple
    from effi_mvs_plus_tpu_torch.parallel import (depth_split_error,
                                                  layout_kinds)
    try:
        kinds = layout_kinds(args.shard_policy)
    except ValueError as e:
        raise SystemExit(f"--shard_policy {args.shard_policy}: {e}")
    if "depth" in kinds and args.model_parallel > 1:
        for s, D in enumerate(int(x) for x in args.ndepths.split(",")):
            why = depth_split_error(D, args.model_parallel,
                                    stage_depth_multiple(s))
            if why:
                raise SystemExit(f"--shard_policy {args.shard_policy}, "
                                 f"stage {s + 1}: {why}")


def _refuse_row_split(args, *datasets):
    """Under spatial sharding, refuse, with the reason, images whose rows
    do not give every model rank a block (read from each dataset's first
    sample)."""
    import numpy as np
    from effi_mvs_plus_tpu_torch.parallel import (layout_kinds,
                                                  row_split_error)
    if "spatial" not in layout_kinds(args.shard_policy) \
            or args.model_parallel == 1:
        return
    for ds in datasets:
        H = np.asarray(ds[0]["imgs"]).shape[-3]
        why = row_split_error(H, args.model_parallel)
        if why:
            raise SystemExit(f"--shard_policy {args.shard_policy}: {why}")


def make_policy(args):
    """The (data, model) grid over the processes and its policy; None for
    a single process."""
    from effi_mvs_plus_tpu_torch import parallel
    world = parallel.world_size()
    mp = args.model_parallel
    dp = args.data_parallel or max(world // mp, 1)
    if dp * mp != world:
        raise SystemExit(f"--data_parallel {dp} x --model_parallel {mp} "
                         f"needs {dp * mp} processes; {world} are running")
    if world == 1:
        return None
    return parallel.make_policy(parallel.global_mesh(model=mp),
                                args.shard_policy)


def shard_indices(n, policy):
    """This data rank's samples: the round-robin partition of the first
    ``n - n % data`` samples, so every rank runs as many batches (a step's
    collectives pair up across ranks)."""
    from effi_mvs_plus_tpu_torch import parallel
    if policy is None or policy.mesh.data == 1:
        return None
    d = policy.mesh.data
    return parallel.partition(range(n - n % d), d, policy.mesh.data_rank)


def global_mean(meter):
    """The mean of a DictMeter's metrics over every batch of every rank."""
    from effi_mvs_plus_tpu_torch import parallel
    tot = parallel.mean_metrics({**meter.sums, "_count": meter.count})
    n = max(tot.pop("_count"), 1e-12)
    return {k: v / n for k, v in tot.items()}


def make_config(args):
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    return EffiMVSConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        gru_iters=tuple(int(x) for x in args.GRUiters.split(",")),
        CostNum=args.CostNum)


def initial_state(args):
    """(state dict or None, checkpoint payload or None, start epoch)."""
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.train import trainer as T
    if args.loadckpt:
        return load_state_dict(args.loadckpt), None, 0
    latest = T.latest_checkpoint(args.logdir) if args.resume else None
    if latest:
        payload = T.load_checkpoint(latest)
        print(f"resuming {latest} at epoch {payload['epoch'] + 1}")
        return payload["model"], payload, payload["epoch"] + 1
    return None, None, 0


def main(argv=None):
    # two-phase parse: --profile (or --mode finetune) picks the preset the
    # remaining defaults come from; explicit flags still win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--profile", default=None)
    pre.add_argument("--mode", default="train")
    ns, _ = pre.parse_known_args(argv)
    profile = ns.profile or ("blend_finetune" if ns.mode == "finetune"
                             else "dtu_train")
    args = build_parser(profile).parse_args(argv)
    _refuse_unported(args)
    if args.mode == "finetune" and not args.loadckpt:
        raise SystemExit("--mode finetune requires --loadckpt")

    from effi_mvs_plus_tpu_torch import parallel
    from effi_mvs_plus_tpu_torch.data import find_dataset
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import (load_optax_state,
                                                     make_optimizer)
    from effi_mvs_plus_tpu_torch.utils.logging import MetricsWriter

    if parallel.initialize(device=args.device):
        print(f"process {parallel.rank()}/{parallel.world_size()} up",
              flush=True)
    dev = resolve_device(parallel.rank_device(args.device))
    cfg = make_config(args)
    policy = (make_policy(args) if args.mode in ("train", "finetune")
              else None)

    ds_cls = find_dataset(args.dataset)
    if args.crop_wh:
        wh = tuple(int(x) for x in args.crop_wh.split(","))
        ds_cls = functools.partial(ds_cls, crop_wh=wh)
    test_ds = ds_cls(args.testpath or args.trainpath, args.testlist, "test",
                     args.testviews, args.numdepth)

    if args.mode == "test":
        return run_test(args, cfg, test_ds, dev)
    if args.mode == "profile":
        return run_profile(args, cfg, test_ds, dev)

    data = 1 if policy is None else policy.mesh.data
    if args.batch_size % data:
        raise SystemExit(f"--batch_size {args.batch_size} does not split "
                         f"over {data} data ranks")
    bs = args.batch_size // data
    # the training reader takes its first trainviews - 1 sources in either
    # mode, as the JAX CLI's does (BlendedMVSDataset samples them only in
    # its mode "finetune", which neither CLI passes)
    train_ds = ds_cls(args.trainpath, args.trainlist, "train",
                      args.trainviews, args.numdepth)
    _refuse_row_split(args, train_ds, test_ds)
    train_idx = shard_indices(len(train_ds), policy)
    test_idx = shard_indices(len(test_ds), policy)
    n_test = len(test_ds) if test_idx is None else len(test_idx)
    eval_bs = bs if n_test >= bs else max(1, n_test)
    main_rank = parallel.is_main()
    if args.device_cache:
        train_loader, test_loader = device_cache_loaders(
            args, train_ds, test_ds, eval_bs * data, policy, dev)
        if main_rank:
            print(f"device cache: {train_loader.nbytes() / 1e9:.2f} GB "
                  f"train + {test_loader.nbytes() / 1e9:.2f} GB eval",
                  flush=True)
    else:
        train_loader = Loader(train_ds, bs, shuffle=True,
                              num_workers=args.num_workers, drop_last=True,
                              seed=args.seed, indices=train_idx)
        test_loader = Loader(test_ds, eval_bs, shuffle=False,
                             drop_last=True, num_workers=args.num_workers,
                             indices=test_idx)

    model, payload, start_epoch = load_model(args, cfg, dev)
    if main_rank:
        print(f"model parameters: "
              f"{sum(p.numel() for p in model.parameters())}")

    total_steps = len(train_loader) * args.epochs + 100
    optimizer, scheduler, sched = make_optimizer(model, args.lr, total_steps,
                                                 weight_decay=args.wd)
    if payload is not None and "opt_state" in payload:
        load_optax_state(model, optimizer, scheduler, payload["opt_state"])
    elif payload is not None:
        optimizer.load_state_dict(payload["optimizer"])
        scheduler.load_state_dict(payload["scheduler"])

    train_step = T.make_train_step(model, optimizer, scheduler,
                                   args.lossrate, seed=args.seed + 1,
                                   device=dev, policy=policy)
    eval_step = T.make_eval_step(model, device=dev, policy=policy)

    writer = MetricsWriter(args.logdir) if main_rank else None
    if writer is not None and args.resume and start_epoch > 0:
        writer.event("resume", epoch=start_epoch,
                     ckpt=T.latest_checkpoint(args.logdir) or "")

    gstep = start_epoch * len(train_loader)
    for epoch in range(start_epoch, args.epochs):
        t_epoch = time.time()
        for i, batch in enumerate(train_loader):
            batch.pop("filename", None)
            metrics = train_step(batch)
            gstep += 1
            if i % args.summary_freq == 0:
                # drop the 13 per-prediction terms (l0..l12), keep 'loss'
                m = parallel.mean_metrics(
                    {k: v for k, v in metrics.items()
                     if not (k[0] == "l" and k[1:].isdigit())})
                if main_rank:
                    writer.scalars(gstep, {**m, "lr": sched(gstep)},
                                   prefix="train/")
                    print(f"epoch {epoch} iter {i}/{len(train_loader)} "
                          f"lr {sched(gstep):.2e} " +
                          " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                          flush=True)
        if epoch % args.save_freq == 0 and main_rank:
            path = os.path.join(args.logdir, f"model_{epoch:06d}.ckpt")
            T.save_checkpoint(path, model, optimizer, scheduler, epoch)
            print(f"saved {path}")

        meter = T.DictMeter()
        for batch in test_loader:
            batch.pop("filename", None)
            m, _ = eval_step(batch)
            meter.update(m)
        means = global_mean(meter)
        if main_rank:
            writer.scalars(gstep, means, prefix="eval/")
            print(f"epoch {epoch} eval: " +
                  " ".join(f"{k}={v:.4f}" for k, v in means.items()) +
                  f" ({time.time() - t_epoch:.1f}s)", flush=True)
    if writer is not None:
        writer.close()
    parallel.barrier()


def device_cache_loaders(args, train_ds, test_ds, eval_batch, policy, dev):
    """The train and eval ``DeviceCacheLoader``s on ``dev``, as the JAX
    CLI builds them (global batches of ``--batch_size`` and
    ``eval_batch``), each rank keeping its data rank's rows; refused, with
    the reason, across hosts (the JAX CLI asserts one process)."""
    from effi_mvs_plus_tpu_torch import parallel
    from effi_mvs_plus_tpu_torch.data.device_cache import DeviceCacheLoader
    if parallel.hosts() > 1:
        raise SystemExit(f"--device_cache holds the set on one host's "
                         f"GPUs; these {parallel.world_size()} processes "
                         f"run on {parallel.hosts()} hosts (the JAX "
                         f"package's cache is single-host too)")
    shard = (1, 0) if policy is None else (policy.mesh.data,
                                           policy.mesh.data_rank)
    try:
        return (DeviceCacheLoader(train_ds, args.batch_size, shuffle=True,
                                  seed=args.seed, drop_last=True,
                                  device=dev, shard=shard),
                DeviceCacheLoader(test_ds, eval_batch, drop_last=True,
                                  device=dev, shard=shard))
    except ValueError as e:
        raise SystemExit(f"--device_cache: {e}")


def load_model(args, cfg, dev):
    """The network on ``dev`` from ``--loadckpt``, ``--resume`` or torch's
    default initialisation drawn from ``--seed``; (model, checkpoint
    payload or None, start epoch)."""
    from effi_mvs_plus_tpu_torch.models import EffiMVS
    torch.manual_seed(args.seed)
    model = EffiMVS(cfg)
    state, payload, start_epoch = initial_state(args)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.to(dev), payload, start_epoch


def run_test(args, cfg, test_ds, dev):
    """The eval suite of ``make_eval_step`` over the eval split, from
    ``--loadckpt`` (or the newest checkpoint with ``--resume``); with
    several processes each evaluates its round-robin share of the samples.
    Returns the mean metrics."""
    from effi_mvs_plus_tpu_torch import parallel
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.train import trainer as T

    model, _, _ = load_model(args, cfg, dev)
    eval_step = T.make_eval_step(model, args.lossrate, device=dev)
    idx = (parallel.partition(range(len(test_ds)))
           if parallel.world_size() > 1 else None)
    meter = T.DictMeter()
    for batch in Loader(test_ds, args.batch_size,
                        num_workers=args.num_workers, indices=idx):
        batch.pop("filename", None)
        m, _ = eval_step(batch)
        meter.update(m)
    means = global_mean(meter)
    if parallel.is_main():
        print("test: " + " ".join(f"{k}={v:.4f}" for k, v in means.items()),
              flush=True)
    return means


def run_profile(args, cfg, test_ds, dev):
    """Training steps on the first eval batch: 3 warm-up steps, 5 timed
    (``utils/profiling.Timer``), then one step traced by ``torch.profiler``
    into ``<logdir>/trace``, the program's spans (``train.step`` and its
    phases, the model's stages) among its events.  Returns the seconds a
    step."""
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
    from effi_mvs_plus_tpu_torch.utils.profiling import Timer, profile_trace

    model, _, _ = load_model(args, cfg, dev)
    optimizer, scheduler, _ = make_optimizer(model, args.lr, 1000,
                                             weight_decay=args.wd)
    train_step = T.make_train_step(model, optimizer, scheduler,
                                   args.lossrate, seed=0, device=dev)
    batch = next(iter(Loader(test_ds, args.batch_size,
                             num_workers=args.num_workers)))
    batch.pop("filename", None)
    batch = T.batch_to_device(batch, dev)

    dt = Timer(lambda: train_step(batch), warmup=3, iters=5,
               device=dev).measure()
    print(f"profile: {dt * 1e3:.1f} ms/step "
          f"({args.batch_size / dt:.2f} samples/s)", flush=True)
    trace_dir = os.path.join(args.logdir, "trace")
    with profile_trace(trace_dir, dev):
        train_step(batch)
    print(f"trace written to {trace_dir}", flush=True)
    return dt


if __name__ == "__main__":
    main()
