"""Training CLI, ``--mode train`` on one device.

The port of ``effi_mvs_plus_tpu/cli/train.py``: the same argument surface
and profiles, the train and eval epochs, per-epoch checkpoints
(``model_NNNNNN.ckpt``, ``train/trainer.py``), the metrics JSONL and
``--resume``.  ``--loadckpt`` takes a shipped ``.npz`` or a port
checkpoint.  Runs on ``--device`` (``cuda`` unless told otherwise).

Not ported yet, and refused with an error: ``--mode finetune``, ``test``
and ``profile``, ``--device_cache``, ``--data_parallel`` /
``--model_parallel`` / ``--shard_policy`` and multi-process runs.

Usage:
  python -m effi_mvs_plus_tpu_torch.cli.train --mode train \
      --trainpath DTU_TRAIN_ROOT --trainlist lists/dtu/train.txt \
      --testlist lists/dtu/test.txt --logdir ckpts --epochs 16 \
      --batch_size 4 --lr 1e-3
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import torch

NOT_PORTED = ("device_cache", "data_parallel", "model_parallel",
              "shard_policy")


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
                   help="init weights from a shipped .npz or a port "
                        "model_NNNNNN.ckpt")
    p.add_argument("--summary_freq", type=int)
    p.add_argument("--save_freq", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--num_workers", type=int)
    p.add_argument("--crop_wh", default=None,
                   help="DTU crop size 'W,H' (default 640,512); smaller "
                        "values centre-crop the images and shift the "
                        "principal point to match")
    # accepted for the JAX CLI's sake, refused until ported
    p.add_argument("--device_cache", action="store_true")
    p.add_argument("--data_parallel", type=int, default=None)
    p.add_argument("--model_parallel", type=int, default=None)
    p.add_argument("--shard_policy", default=None)
    apply_profile_defaults(p, get_profile(profile_name))
    return p


def _refuse_unported(args):
    if args.mode != "train":
        raise SystemExit(f"--mode {args.mode} is not ported yet; the port "
                         f"trains (--mode train)")
    for flag in NOT_PORTED:
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag} is not ported yet")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit("multi-process training is not ported yet")


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
    # two-phase parse: --profile picks the preset the remaining defaults
    # come from; explicit flags still win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--profile", default=None)
    ns, _ = pre.parse_known_args(argv)
    args = build_parser(ns.profile or "dtu_train").parse_args(argv)
    _refuse_unported(args)

    from effi_mvs_plus_tpu_torch.data import find_dataset
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.models import EffiMVS
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
    from effi_mvs_plus_tpu_torch.utils.logging import MetricsWriter

    dev = resolve_device(args.device)
    cfg = make_config(args)

    ds_cls = find_dataset(args.dataset)
    if args.crop_wh:
        wh = tuple(int(x) for x in args.crop_wh.split(","))
        ds_cls = functools.partial(ds_cls, crop_wh=wh)
    test_ds = ds_cls(args.testpath or args.trainpath, args.testlist, "test",
                     args.testviews, args.numdepth)
    train_ds = ds_cls(args.trainpath, args.trainlist, "train",
                      args.trainviews, args.numdepth)
    eval_bs = args.batch_size if len(test_ds) >= args.batch_size \
        else max(1, len(test_ds))
    train_loader = Loader(train_ds, args.batch_size, shuffle=True,
                          num_workers=args.num_workers, drop_last=True,
                          seed=args.seed)
    test_loader = Loader(test_ds, eval_bs, shuffle=False, drop_last=True,
                         num_workers=args.num_workers)

    # a model built from scratch takes torch's default initialisation,
    # drawn from --seed
    torch.manual_seed(args.seed)
    model = EffiMVS(cfg)
    state, payload, start_epoch = initial_state(args)
    if state is not None:
        model.load_state_dict(state, strict=True)
    model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model parameters: {n_params}")

    total_steps = len(train_loader) * args.epochs + 100
    optimizer, scheduler, sched = make_optimizer(model, args.lr, total_steps,
                                                 weight_decay=args.wd)
    if payload is not None:
        optimizer.load_state_dict(payload["optimizer"])
        scheduler.load_state_dict(payload["scheduler"])

    train_step = T.make_train_step(model, optimizer, scheduler,
                                   args.lossrate, seed=args.seed + 1,
                                   device=dev)
    eval_step = T.make_eval_step(model, device=dev)

    writer = MetricsWriter(args.logdir)
    if args.resume and start_epoch > 0:
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
                m = {k: float(v) for k, v in metrics.items()
                     if not (k[0] == "l" and k[1:].isdigit())}
                writer.scalars(gstep, {**m, "lr": sched(gstep)},
                               prefix="train/")
                print(f"epoch {epoch} iter {i}/{len(train_loader)} "
                      f"lr {sched(gstep):.2e} " +
                      " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                      flush=True)
        if epoch % args.save_freq == 0:
            path = os.path.join(args.logdir, f"model_{epoch:06d}.ckpt")
            T.save_checkpoint(path, model, optimizer, scheduler, epoch)
            print(f"saved {path}")

        meter = T.DictMeter()
        for batch in test_loader:
            batch.pop("filename", None)
            m, _ = eval_step(batch)
            meter.update(m)
        means = meter.mean()
        writer.scalars(gstep, means, prefix="eval/")
        print(f"epoch {epoch} eval: " +
              " ".join(f"{k}={v:.4f}" for k, v in means.items()) +
              f" ({time.time() - t_epoch:.1f}s)", flush=True)
    writer.close()


if __name__ == "__main__":
    main()
