"""Serving in a closed loop: one caller hands ``InferenceEngine.infer_batch``
a batch as soon as the last one's depth and confidence are on the host,
cycling a small pool of batches rendered from the seed and kept in
pageable host memory as numpy, as the port's ``Loader`` yields them, so
the upload is inside every call.

Parameters (the cell's ``params``): ``batch`` (B), ``pool`` (batches
rendered), ``sample`` (answers kept, reservoir-sampled from the seed, for
the check), ``trace_units`` (batches in the traced stretch).

End-to-end: ``maps_per_s`` (maps returned over the window's length),
``batch_p90_ms`` (90th percentile of every batch's latency, call to maps
on the host), ``peak_mem_gib``.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch
from torch.profiler import record_function as span

from portbench.lib import compare, controls, counts, scene
from portbench.reference import model as ref_model
from portbench.reference import weights as ref_weights


def _engine(ctx):
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    m = ctx.config["model"]
    cfg = EffiMVSConfig(ndepths=tuple(m["ndepths"]),
                        gru_iters=tuple(m["gru_iters"]),
                        CostNum=m["cost_num"],
                        compute_dtype=getattr(torch, m["compute_dtype"]))
    return InferenceEngine(load_state_dict(str(ctx.root / ctx.config[
        "checkpoint"])), cfg, device=ctx.device)


def _device_batch(batch, rows, device):
    return {"imgs": torch.from_numpy(batch["imgs"][rows]).to(device),
            "proj_matrices": {k: torch.from_numpy(v[rows]).to(device)
                              for k, v in batch["proj_matrices"].items()},
            "depth_values": torch.from_numpy(
                batch["depth_values"][rows]).to(device)}


def reference_answers(params, model_cfg, batch, device, quant=None,
                      counter=None):
    """[(depth (H,W), conf (H/2,W/2))] of the reference, a batch row at a
    time in fp32 with TF32 off, float64 numpy."""
    out = []
    for b in range(batch["imgs"].shape[0]):
        with torch.no_grad(), controls.precision():
            preds, conf = ref_model.Reference(
                params, model_cfg, quant=quant, counter=counter).forward(
                **_device_batch(batch, slice(b, b + 1), device))
        out.append((preds[-1][0].double().cpu().numpy(),
                    conf[0].double().cpu().numpy()))
    return out


class Session:
    def __init__(self, ctx, engine=None):
        self.ctx = ctx
        p = ctx.params
        inp = ctx.config["input"]
        self.B = p["batch"]
        self.engine = engine or _engine(ctx)
        self.pool = [scene.render_batch(ctx.config["scene"], self.B,
                                        inp["views"], inp["height"],
                                        inp["width"], ctx.seed, i,
                                        ctx.device)
                     for i in range(p["pool"])]
        for batch in self.pool:             # every shape of the window
            self.engine.infer_batch(batch)
        self.rng = random.Random(ctx.seed)
        self.sample = p["sample"]
        self.work = {}
        self.begin_window()

    def begin_window(self):
        self.calls = self.failed = 0
        self.latencies = []
        self.kept = []

    def step(self):
        with span("bench.next_batch"):
            i = self.calls % len(self.pool)
            batch = self.pool[i]
        t0 = time.perf_counter()
        try:
            with span("engine.infer_batch"):
                depth, conf = self.engine.infer_batch(batch)
        except RuntimeError as e:
            self.calls += 1
            self.failed += 1
            print(f"batch {self.calls}: {e}", flush=True)
            return
        self.latencies.append(time.perf_counter() - t0)
        with span("bench.sample"):
            # reservoir sample of the window's answers, drawn from the seed
            n = len(self.latencies)
            slot = n - 1 if n <= self.sample else self.rng.randrange(n)
            if slot < self.sample:
                entry = (i, depth, conf)
                if slot < len(self.kept):
                    self.kept[slot] = entry
                else:
                    self.kept.append(entry)
        self.calls += 1

    @property
    def attempted(self):
        return self.calls

    def window_metrics(self, elapsed):
        done = len(self.latencies)
        return {"maps_per_s": self.B * done / elapsed,
                "batch_p90_ms": float(np.percentile(self.latencies, 90))
                * 1e3 if done else None}

    def release(self):
        del self.engine
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, traced=False):
        """Numbers of the sampled answers against the reference; with
        ``traced`` also the kernels' work a batch from the reference's
        hypotheses over the whole pool."""
        ctx = self.ctx
        model_cfg = ctx.config["model"]
        params = ref_weights.to_device(ref_weights.load_npz(
            ctx.root / ctx.config["checkpoint"]), ctx.device)
        need = sorted({i for i, _, _ in self.kept}
                      | (set(range(len(self.pool))) if traced else set()))
        refs, per_batch = {}, []
        for i in need:
            counter = ref_model.Counter() if traced else None
            refs[i] = reference_answers(params, model_cfg, self.pool[i],
                                        ctx.device, counter=counter)
            if traced:
                per_batch.append(self._work(counter))
        if traced:
            self.work = {k: _mean_launches([w[k] for w in per_batch])
                         for k in ("k1", "k2", "k4")}
            self.work["model_flops"] = float(np.mean(
                [w["model_flops"] for w in per_batch]))
            self.work["dtype"] = model_cfg["compute_dtype"]
        self.refs = refs
        pairs = [(d[b], c[b], *refs[i][b]) for i, d, c in self.kept
                 for b in range(self.B)]
        return compare.serving_numbers(pairs)

    def _work(self, counter):
        """One batch's launches [(bytes, flops, dtype)] of K1 (a stage
        each, the batch rows' work summed), K2 and K4, and its FLOPs."""
        inp, m = self.ctx.config["input"], self.ctx.config["model"]
        dt = m["compute_dtype"]
        k1 = {}
        for rec, (b, f) in zip(counter.warps,
                               counts.warp_launches(counter.warps, dt)):
            acc = k1.setdefault(rec["stage"], [0, 0])
            acc[0] += b
            acc[1] += f
        H, W = inp["height"], inp["width"]
        return {"k1": [(b, f, dt) for b, f in k1.values()],
                "k2": [(b, f, dt) for b, f in counts.k2_launches(
                    m, self.B, H, W, dt)],
                "k4": [(b, f, dt) for b, f in counts.k4_launches(
                    m, self.B, inp["views"], H, W, dt)],
                "model_flops": counter.fwd}


def _mean_launches(lists):
    """Element-wise mean of equally long launch lists."""
    n = len(lists)
    return [(sum(x[j][0] for x in lists) / n, sum(x[j][1] for x in lists) / n,
             lists[0][j][2]) for j in range(len(lists[0]))]


def _conf_one_bin_late(prob):
    """The photometric confidence read one bin past the expected index: a
    planted fault of the confidence alone."""
    B, D, H, W = prob.shape
    p = torch.nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = p[:, 0:D] + p[:, 1:D + 1] + p[:, 2:D + 2] + p[:, 3:D + 3]
    ar = torch.arange(D, dtype=prob.dtype, device=prob.device)
    idx = torch.sum(prob * ar[None, :, None, None], 1).to(torch.int64) + 1
    return torch.gather(sum4, 1, torch.clamp(idx, 0, D - 1)[:, None])[:, 0]


def calibrate(ctx, shared):
    """One seed's readings for the limits: the program's timed path over
    the pool against the reference, the fp8 control's, and three planted
    faults of the confidence alone (the reference's depth kept): zeros,
    the next batch row's, and read one bin late.  ``shared`` keeps the
    engine from one seed to the next."""
    sess = Session(ctx, shared.get("engine"))
    shared["engine"] = sess.engine
    for _ in range(max(sess.sample, len(sess.pool))):
        sess.step()
    program = sess.check()
    params = ref_weights.to_device(ref_weights.load_npz(
        ctx.root / ctx.config["checkpoint"]), ctx.device)
    pairs, faults = [], {"conf_zero": [], "conf_next_row": [],
                         "conf_bin_late": []}
    for i, batch in enumerate(sess.pool):
        ref = sess.refs.get(i) or reference_answers(
            params, ctx.config["model"], batch, ctx.device)
        ctl = reference_answers(params, ctx.config["model"], batch,
                                ctx.device, quant=controls.fp8)
        pairs += [(c[0], c[1], *r) for c, r in zip(ctl, ref)]
        true_conf = ref_model.photometric_confidence
        ref_model.photometric_confidence = _conf_one_bin_late
        try:
            late = reference_answers(params, ctx.config["model"], batch,
                                     ctx.device)
        finally:
            ref_model.photometric_confidence = true_conf
        for b, (d, c) in enumerate(ref):
            faults["conf_zero"].append((d, np.zeros_like(c), d, c))
            faults["conf_next_row"].append(
                (d, ref[(b + 1) % len(ref)][1], d, c))
            faults["conf_bin_late"].append((d, late[b][1], d, c))
    return {"program": program, "control": compare.serving_numbers(pairs),
            "faults": {k: compare.serving_numbers(v)
                       for k, v in faults.items()}}
