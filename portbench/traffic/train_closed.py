"""Training in a closed loop: one training job runs the step closure of
``train/trainer.py`` ``make_train_step`` back to back on host batches
(numpy in pageable memory, as the ``Loader`` yields them), each step
synchronised by reading its loss back before the next starts.

Set-up builds one training object (the model from the checkpoint, AdamW
with the one-cycle schedule, the step with its dropout generator seeded
from the seed) and drives its first three steps through the window's
own call on three different pool batches; the window then goes on with
the same object.  Those three steps are what the reference follows.

Parameters (the cell's ``params``): ``pool`` (batches rendered, at
least 3),
``trace_units`` (steps in the traced stretch); the batch is the
configuration's.

End-to-end: ``samples_per_s`` (samples whose step completed over the
window's length), ``peak_mem_gib``.
"""

from __future__ import annotations

import gc
import math

import torch
from torch.profiler import record_function as span

from portbench.lib import compare, controls, counts, scene
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference import weights as ref_weights

CHECKED_STEPS = 3


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(tree).to(device)


def reference_steps(ctx, batches, quant=None, counter=None, rows=None,
                    tf32=False):
    """The reference's readings over ``batches`` from the checkpoint, in
    fp32 with TF32 off (in TF32 with ``tf32``, the control): {'losses',
    'grad' (first step's, a norm a leaf), 'change' (a norm a leaf after
    the last)}."""
    with controls.precision(tf32):
        return _reference_steps(ctx, batches, quant, counter, rows)


def _reference_steps(ctx, batches, quant, counter, rows):
    params = ref_weights.to_device(ref_weights.load_npz(
        ctx.root / ctx.config["checkpoint"]), ctx.device, trainable=True)
    start = {k: v.detach().clone() for k, v in params.items()
             if v.requires_grad}
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    trainer = ref_train.Trainer(params, ctx.config["model"],
                                ctx.config["train"], gen, quant, counter)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        loss, grads = trainer.step(_to_device(batch, ctx.device), rows)
        out["losses"].append(loss)
        if i == 0:
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
    out["change"] = {k: float((params[k].detach() - v).norm())
                     for k, v in start.items()}
    return out


class Session:
    def __init__(self, ctx):
        from effi_mvs_plus_tpu_torch.io import load_state_dict
        from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model
        from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
        from effi_mvs_plus_tpu_torch.train.trainer import make_train_step

        self.ctx = ctx
        p = ctx.params
        m, t, inp = ctx.config["model"], ctx.config["train"], \
            ctx.config["input"]
        self.B = t["batch_size"]
        cfg = EffiMVSConfig(ndepths=tuple(m["ndepths"]),
                            gru_iters=tuple(m["gru_iters"]),
                            CostNum=m["cost_num"],
                            compute_dtype=getattr(torch, m["compute_dtype"]))
        self.model = build_model(load_state_dict(str(
            ctx.root / ctx.config["checkpoint"])), cfg, ctx.device)
        self.opt, sched, _ = make_optimizer(self.model, t["lr"],
                                            t["total_steps"],
                                            t["weight_decay"])
        self.train_step = make_train_step(self.model, self.opt, sched,
                                          t["loss_rate"], seed=ctx.seed,
                                          device=ctx.device)
        self.pool = [scene.render_batch(ctx.config["scene"], self.B,
                                        inp["views"], inp["height"],
                                        inp["width"], ctx.seed, i,
                                        ctx.device, with_depth=True)
                     for i in range(p["pool"])]
        if len(self.pool) < CHECKED_STEPS:
            raise ValueError(f"a pool of {CHECKED_STEPS} batches at least")
        self.work = {}
        # the first steps: the checked ones, and every shape of the window
        named = dict(self.model.named_parameters())
        start = {k: v.detach().clone() for k, v in named.items()}
        self.calls = 0
        self.readings = {}
        self.begin_window()
        for i in range(CHECKED_STEPS):
            self.step()
            if i == 0:
                # the gradient AdamW received, from its first moment
                beta1 = self.opt.param_groups[0]["betas"][0]
                self.readings["grad"] = {
                    k: float(self.opt.state[v]["exp_avg"].norm() / (1 - beta1))
                    if "exp_avg" in self.opt.state.get(v, {}) else 0.0
                    for k, v in named.items()}
        self.readings["losses"] = list(self.losses)
        self.readings["change"] = {k: float((v.detach() - start[k]).norm())
                                   for k, v in named.items()}
        del start
        self.begin_window()

    def begin_window(self):
        self.steps = self.failed = 0
        self.losses = []

    def step(self):
        with span("bench.next_batch"):
            batch = self.pool[self.calls % len(self.pool)]
        with span("trainer.step"):
            metrics = self.train_step(batch)
        with span("bench.readback"):
            loss = float(metrics["loss"])
        self.calls += 1
        self.steps += 1
        self.losses.append(loss)
        if not math.isfinite(loss):
            self.failed += 1

    @property
    def attempted(self):
        return self.steps

    def window_metrics(self, elapsed):
        return {"samples_per_s": self.B * (self.steps - self.failed)
                / elapsed}

    def release(self):
        del self.model, self.opt, self.train_step
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, traced=False):
        counter = ref_model.Counter() if traced else None
        ref = reference_steps(self.ctx, self.pool[:CHECKED_STEPS],
                              counter=counter)
        if traced:
            self.work = self._work(counter)
        self.ref = ref
        numbers, worst = compare.training_numbers(self.readings, ref)
        self.worst = worst
        return numbers

    def _work(self, counter):
        """A step's launches of K1, K3 (a stage each, the checked steps'
        mean) and K2, and its FLOPs, forward and backward."""
        m, inp = self.ctx.config["model"], self.ctx.config["input"]
        dt = m["compute_dtype"]
        n = CHECKED_STEPS
        per_stage = {}
        for back in (False, True):
            for rec, (b, f) in zip(counter.warps, counts.warp_launches(
                    counter.warps, dt, backward=back)):
                acc = per_stage.setdefault((back, rec["stage"]), [0, 0])
                acc[0] += b / n
                acc[1] += f / n
        return {"k1": [(b, f, dt) for (back, _), (b, f) in per_stage.items()
                       if not back],
                "k3": [(b, f, dt) for (back, _), (b, f) in per_stage.items()
                       if back],
                "k2": [(b, f, dt) for b, f in counts.k2_launches(
                    m, self.B, inp["height"], inp["width"], dt)],
                "model_flops": (counter.fwd + counter.bwd) / n,
                "dtype": dt}


def _in_tf32(make_train_step):
    """``make_train_step`` whose step runs in TF32: the program with TF32
    switched on, whatever its own set-up set."""
    def make(*a, **k):
        step = make_train_step(*a, **k)

        def run(batch):
            with controls.precision(tf32=True):
                return step(batch)
        return run
    return make


def calibrate(ctx, shared):
    """One seed's readings for the limits: the program's first three steps
    against the reference, the TF32 control's, and two planted faults:
    half the batch left out of the reference (the mean taken over the
    rest), and the program's own steps with TF32 switched on."""
    from effi_mvs_plus_tpu_torch.train import trainer
    sess = Session(ctx)
    sess.release()
    out = {"program": sess.check(), "worst_leaf": sess.worst}
    batches = sess.pool[:CHECKED_STEPS]
    ctl = reference_steps(ctx, batches, tf32=True)
    out["control"] = compare.training_numbers(ctl, sess.ref)[0]
    half = reference_steps(ctx, batches, rows=slice(0, sess.B // 2))
    faults = {"half_batch": compare.training_numbers(half, sess.ref)[0]}
    true_step = trainer.make_train_step
    trainer.make_train_step = _in_tf32(true_step)
    try:
        prog_tf32 = Session(ctx)
    finally:
        trainer.make_train_step = true_step
    prog_tf32.release()
    faults["program_tf32"] = compare.training_numbers(prog_tf32.readings,
                                                      sess.ref)[0]
    out["faults"] = faults
    return out
