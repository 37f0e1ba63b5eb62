"""Training and evaluation steps, the metric meter and checkpoints.

The port of ``effi_mvs_plus_tpu/train/trainer.py``.  Where the JAX step is
a pure jitted function of (params, opt_state, batch, rng), the port's
step updates the model, optimizer and scheduler in place: forward in
train mode (BN batch statistics, per-view groups, dropout drawn from the
step's own generator), ``mvs_loss``, backward, AdamW, the schedule step;
the BN running statistics update during the forward.

Each step lives on one device, ``cuda`` unless the caller passes
``device="cpu"``, and raises without a GPU; the model must already be on
that device.  Batches are the loader's numpy pytrees or the device
cache's tensors.  With a ``ShardingPolicy`` (``parallel/mesh.py``) the
step runs under it: each data rank passes its rows of the global batch,
the forward and the loss compute what the whole batch computes, and the
gradients are averaged over the grid's groups before AdamW
(``ShardingPolicy.sync_gradients``).

Spans (``utils/profiling.py``): a step is the unit ``train.step``,
holding ``train.upload`` (``batch_to_device``), ``train.forward`` (the
model and the loss), ``train.backward`` (the backward and the gradients'
sync) and ``train.optimizer`` (the gradients' reset, AdamW, the schedule
and the metrics), the last three with the device's time under tracing.

Checkpoints are ``model_NNNNNN.ckpt`` files written with ``torch.save``:
``{"model", "optimizer", "scheduler", "epoch"}``, where ``"model"`` is the
state dict in the reference's own names.  ``load_checkpoint`` and
``latest_checkpoint`` also take the JAX train CLI's ``model_NNNNNN.ckpt``
pickles in the same logdir: its payload comes back as
``{"model", "opt_state", "epoch"}``, the optax state for
``optim.load_optax_state``.  An orbax ``model_NNNNNN/`` directory counts
in the ordering and is refused, with the reason, when it is the one to
load.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.device import resolve_device
from effi_mvs_plus_tpu_torch.io import jax_checkpoint as jc
from effi_mvs_plus_tpu_torch.io import params_from_jax
from effi_mvs_plus_tpu_torch.parallel import mesh as par
from effi_mvs_plus_tpu_torch.train.loss import (abs_depth_error, mvs_loss,
                                                threshold_error)
from effi_mvs_plus_tpu_torch.utils.profiling import span

_MODEL_INPUTS = ("imgs", "proj_matrices", "depth_values")


def batch_to_device(batch, device):
    """numpy (or torch) pytree -> torch tensors on ``device``; floats
    become float32, strings and lists of strings stay as they are.  A
    float32 (or non-float) tensor already on ``device``, as the device
    cache's batches, passes through as it is, without a copy."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        if batch.is_floating_point():
            batch = batch.float()
        return batch.to(device, non_blocking=True)
    return batch


def _check_model_device(model, dev):
    got = next(model.parameters()).device
    if got != dev and not (got.type == dev.type == "cuda"
                           and dev.index is None):
        raise ValueError(f"the model is on {got}, the step on {dev}")


def _final_metrics(final_depth, batch):
    gt = batch["depth"]["stage4"]
    mask = batch["mask"]["stage4"]
    return {
        "abs_depth_error": abs_depth_error(final_depth, gt, mask),
        "thres2mm_error": threshold_error(final_depth, gt, mask, 2.0),
        "thres4mm_error": threshold_error(final_depth, gt, mask, 4.0),
        "thres8mm_error": threshold_error(final_depth, gt, mask, 8.0),
    }


def make_train_step(model, optimizer, scheduler, loss_rate=1.0, seed=0,
                    device=None, policy=None):
    """Returns ``step(batch) -> metrics`` (0-d tensors on the device):
    loss, abs_depth_error, thres{2,4,8}mm_error and the 13
    per-prediction losses l0..l12.  Dropout masks come from a generator
    the step owns, seeded with ``seed`` (the same on every rank).  Under
    ``policy`` the loss and its terms are the global batch's; the other
    metrics are this rank's rows'."""
    dev = resolve_device(device)
    _check_model_device(model, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nn.use_generator(model, gen)

    def step(batch):
        with span("train.step"):
            with span("train.upload"):
                batch = batch_to_device(batch, dev)
            model.train()
            with par.use_policy(policy), span("train.forward", dev):
                out = model(*(batch[k] for k in _MODEL_INPUTS))
                loss, per = mvs_loss(out["depth"], batch["depth"],
                                     batch["mask"], loss_rate)
            with span("train.optimizer", dev):
                optimizer.zero_grad(set_to_none=True)
            with span("train.backward", dev):
                loss.backward()
                if policy is not None:
                    policy.sync_gradients(model)
            with span("train.optimizer", dev):
                optimizer.step()
                scheduler.step()
                with torch.no_grad():
                    metrics = {"loss": loss.detach(),
                               **_final_metrics(out["depth"][-1], batch)}
                metrics.update({k: v.detach() for k, v in per.items()})
            return metrics

    return step


# eval suite: (name, absolute threshold); the names are the reference's
# historical ones, the values are what it computes
_THRES = (("thres2mm_error", 0.125), ("thres4mm_error", 0.25),
          ("thres8mm_error", 0.5), ("thres14mm_error", 1.0),
          ("thres20mm_error", 20.0))
_BANDS = (("thres2mm_abserror", (0.0, 2.0)),
          ("thres4mm_abserror", (2.0, 4.0)),
          ("thres8mm_abserror", (4.0, 8.0)),
          ("thres14mm_abserror", (8.0, 14.0)),
          ("thres20mm_abserror", (14.0, 20.0)),
          ("thres>20mm_abserror", (20.0, 1e5)))


def make_eval_step(model, loss_rate=1.0, device=None, policy=None):
    """Returns ``step(batch) -> (metrics, final depth)``, no gradients, the
    model in eval mode: loss, depth_loss (the last prediction's),
    abs_depth_error, thresholds 0.125/0.25/0.5/1/20 mm, six banded
    absolute errors and l0..l12 — the reference's eval scalar suite;
    under ``policy`` as for the train step."""
    dev = resolve_device(device)
    _check_model_device(model, dev)

    def step(batch):
        batch = batch_to_device(batch, dev)
        model.eval()
        with torch.inference_mode(), par.use_policy(policy):
            out = model(*(batch[k] for k in _MODEL_INPUTS))
            depth = out["depth"][-1]
            total, per = mvs_loss(out["depth"], batch["depth"],
                                  batch["mask"], loss_rate)
            gt = batch["depth"]["stage4"]
            mask = batch["mask"]["stage4"]
            m = {"loss": total,
                 "depth_loss": per[f"l{len(out['depth']) - 1}"],
                 "abs_depth_error": abs_depth_error(depth, gt, mask)}
            for name, t in _THRES:
                m[name] = threshold_error(depth, gt, mask, t)
            for name, band in _BANDS:
                m[name] = abs_depth_error(depth, gt, mask, band)
            m.update(per)
        return m, depth

    return step


class DictMeter:
    """Running mean of metric dicts."""

    def __init__(self):
        self.sums = {}
        self.count = 0

    def update(self, d):
        for k, v in d.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
        self.count += 1

    def mean(self):
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}


def save_checkpoint(path, model, optimizer, scheduler, epoch):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(), "epoch": int(epoch)},
               path)


def load_checkpoint(path):
    """The payload of the port's ``save_checkpoint`` (tensors on the CPU),
    or of the JAX package's as ``{"model": state dict, "opt_state",
    "epoch"}``; an orbax directory raises ValueError with the reason."""
    if jc.checkpoint_format(path) != "jax":
        return torch.load(path, map_location="cpu", weights_only=True)
    payload = jc.read_jax_checkpoint(path)
    return {"model": params_from_jax(payload["params"]),
            "opt_state": payload.get("opt_state"), "epoch": payload["epoch"]}


def latest_checkpoint(logdir):
    """The highest-epoch ``model_NNNNNN.ckpt`` (either package's) or
    orbax ``model_NNNNNN`` directory in logdir, or None."""
    if not os.path.isdir(logdir):
        return None
    cands = [f for f in os.listdir(logdir)
             if f.startswith("model_") and f[6:].split(".")[0].isdigit()
             and (f.endswith(".ckpt")
                  or os.path.isdir(os.path.join(logdir, f)))]
    if not cands:
        return None
    cands.sort(key=lambda x: int(x[6:].split(".")[0]))
    return os.path.join(logdir, cands[-1])
