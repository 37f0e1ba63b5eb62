"""Optimizer and learning-rate schedule of the reference recipe.

The port of ``effi_mvs_plus_tpu/train/optim.py``: AdamW over all the
parameters (betas 0.9/0.999, eps 1e-8, decoupled weight decay 1e-3) with
a linear one-cycle schedule — warm-up from max_lr/25 over 5% of the steps,
then a linear anneal to max_lr/25/1e4.  BN running statistics are
buffers, not parameters, so AdamW never sees them, as ``trainable_mask``
keeps them out there.

The schedule is ``onecycle_linear``, step for step the JAX package's
(``optax.join_schedules`` of two ``linear_schedule``s), applied through a
``LambdaLR``; ``torch.optim.lr_scheduler.OneCycleLR`` places its warm-up
boundary differently.
"""

from __future__ import annotations

import torch


def onecycle_linear(max_lr, total_steps, pct_start=0.05, div_factor=25.0,
                    final_div_factor=1e4):
    """step -> learning rate."""
    init = max_lr / div_factor
    final = init / final_div_factor
    warm = max(int(total_steps * pct_start), 1)
    rest = max(total_steps - warm, 1)

    def linear(begin, end, steps, count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (begin - end) * frac + end

    def sched(step):
        if step < warm:
            return linear(init, max_lr, warm, step)
        return linear(max_lr, final, rest, step - warm)
    return sched


def make_optimizer(model, lr, total_steps, weight_decay=1e-3):
    """(AdamW over ``model.parameters()``, its LambdaLR scheduler, the
    schedule as a function of the step)."""
    sched = onecycle_linear(lr, total_steps)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / lr)
    return opt, scheduler, sched
