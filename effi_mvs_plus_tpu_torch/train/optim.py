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

``load_optax_state`` carries a JAX run's optimizer over: the AdamW
moments of its ``opt_state`` (read by ``io.read_jax_checkpoint``) into
the port's ``AdamW``, its step counts into the ``AdamW`` steps and the
``LambdaLR``.  The two updates agree step for step: optax reads the
schedule at its count and then increments it, as the port's step runs
AdamW at ``sched(last_epoch)`` and then ``scheduler.step()``; after n
updates both stand at n, so the count carries over as it is.
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.io import jax_checkpoint as jc
from effi_mvs_plus_tpu_torch.io.torch_import import (complete_state_dict,
                                                     torch_leaves)


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


def _optax_states(state):
    """The optax state's leaves of the two kinds the port carries:
    {ScaleByAdamState or ScaleByScheduleState class: state}."""
    found = {}
    if isinstance(state, (jc.ScaleByAdamState, jc.ScaleByScheduleState)):
        found[type(state)] = state
    elif isinstance(state, tuple):
        for s in state:
            found.update(_optax_states(s))
    return found


def load_optax_state(model, optimizer, scheduler, opt_state):
    """Fill ``make_optimizer``'s AdamW and LambdaLR from the JAX package's
    optax AdamW state (``optax.masked`` of ``scale_by_adam``,
    ``add_decayed_weights``, ``scale_by_schedule``, in the stand-ins of
    ``io.jax_checkpoint``): ``mu``/``nu`` become ``exp_avg``/
    ``exp_avg_sq`` through the weights' relayout, the Adam count each
    parameter's ``step``, the schedule's count the scheduler's
    ``last_epoch`` and the learning rate ``sched(count)``.  The BN running
    statistics are masked in JAX and buffers here: no moments."""
    states = _optax_states(opt_state)
    adam = states.get(jc.ScaleByAdamState)
    sched = states.get(jc.ScaleByScheduleState)
    if adam is None or sched is None:
        raise ValueError(f"not an optax AdamW state with a schedule: "
                         f"{type(opt_state).__name__}")
    # by every name of a parameter, the ModuleList aliases' too
    mu = complete_state_dict(torch_leaves(adam.mu))
    nu = complete_state_dict(torch_leaves(adam.nu))
    step = torch.tensor(float(adam.count), dtype=torch.float32)
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    state = {}
    for name, p in model.named_parameters():
        if name not in mu or mu[name].shape != p.shape:
            raise ValueError(f"the optax state has no moments of shape "
                             f"{tuple(p.shape)} for {name}")
        state[index[id(p)]] = {"step": step.clone(), "exp_avg": mu[name],
                               "exp_avg_sq": nu[name]}
    count = int(sched.count)
    lrs = [base * fn(count)
           for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    groups = optimizer.state_dict()["param_groups"]
    for g, lr in zip(groups, lrs):
        g["lr"] = lr
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    scheduler.load_state_dict({**scheduler.state_dict(), "last_epoch": count,
                               "_step_count": count + 1, "_last_lr": lrs})
