"""The reference's training step: the multi-stage smooth-L1 loss, AdamW
and the linear one-cycle schedule, in plain PyTorch.

The loss supervises the 13 predictions against the ground-truth pyramid
stages [1,1,1,1,2,2,2,2,3,3,3,3,4], each the mean smooth-L1 over the
pixels whose mask exceeds 0.5, weighted 1 for the first and
``loss_rate ** (12 - i)`` for the others.  AdamW has betas 0.9/0.999,
eps 1e-8 and decoupled weight decay; the schedule warms up linearly from
max_lr/25 over 5% of the steps and anneals linearly to max_lr/25/1e4.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import Reference

PRED_STAGE = (1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4)
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def mvs_loss(preds, depth, mask, loss_rate):
    total = 0.0
    for i, pred in enumerate(preds):
        k = f"stage{PRED_STAGE[i]}"
        m = (mask[k] > 0.5).float()
        li = (smooth_l1(pred, depth[k]) * m).sum() / m.sum().clamp_min(1.0)
        total = total + (1.0 if i == 0 else loss_rate ** (len(preds) - i - 1)
                         ) * li
    return total


def onecycle(max_lr, total_steps, pct_start=0.05, div=25.0,
             final_div=1e4):
    """step -> learning rate."""
    init = max_lr / div
    final = init / final_div
    warm = max(int(total_steps * pct_start), 1)
    rest = max(total_steps - warm, 1)

    def linear(begin, end, steps, count):
        return (begin - end) * (1.0 - min(max(count, 0), steps) / steps) + end

    return lambda step: (linear(init, max_lr, warm, step) if step < warm
                         else linear(max_lr, final, rest, step - warm))


class Trainer:
    """Parameters (a dict of float32 tensors that require grad), their
    AdamW moments and the step count; ``step(batch)`` runs one step in
    train mode and returns its loss and the gradients AdamW received."""

    def __init__(self, params, cfg, train_cfg, generator, quant=None,
                 counter=None):
        self.params = params
        self.cfg = cfg
        self.lr = onecycle(train_cfg["lr"], train_cfg["total_steps"])
        self.wd = train_cfg["weight_decay"]
        self.loss_rate = train_cfg["loss_rate"]
        self.generator = generator
        self.quant = quant
        self.counter = counter
        self.count = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()
                  if v.requires_grad}
        self.v = {k: torch.zeros_like(params[k]) for k in self.m}

    def step(self, batch, rows=None):
        """batch: tensors on the parameters' device.  ``rows``: the batch
        rows that enter the loss (all of them by default)."""
        if rows is not None:
            batch = _rows(batch, rows)
        net = Reference(self.params, self.cfg, training=True,
                        generator=self.generator, quant=self.quant,
                        counter=self.counter)
        preds, _ = net.forward(batch["imgs"], batch["proj_matrices"],
                               batch["depth_values"])
        loss = mvs_loss(preds, batch["depth"], batch["mask"],
                        self.loss_rate)
        names = list(self.m)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        with torch.no_grad():
            for k, g in zip(names, grads):
                p, m, v = self.params[k], self.m[k], self.v[k]
                p.mul_(1 - lr * self.wd)
                m.lerp_(g, 1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                p.addcdiv_(m, denom, value=-lr / bc1)
        return float(loss.detach()), dict(zip(names, grads))


def _rows(tree, rows):
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return tree[rows]
