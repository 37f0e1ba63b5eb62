"""The training step's weight gradients on the card: which layers cuDNN's
weight-gradient kernels serve, and what each layer's shape costs through
cuDNN, through ``ops/conv_wgrad.py``'s split-K GEMM and through cuDNN
with ``cudnn.benchmark`` (a measurement only).

    python3 scripts/torch_probe_wgrad.py [--seed N] [--out FILE]

Needs one CUDA GPU; imports nothing of JAX.  Runs the ``dtu_train-b4``
cell's session (``portbench/traffic/train_closed.py``: 640x512, 5 views,
B=4, fp32 with TF32 off, the shipped DTU weights) and prints one JSON
object a line:

* ``layers``: every distinct 2-D convolution, 3-D convolution and 3-D
  transposed convolution whose weight trains (input and weight shapes,
  stride, padding, output padding), its calls a step and the modules
  that make it (one forward of the plain kernels' path, a stack of
  module names from forward hooks);
* ``attribution``: 3 steps with every weight gradient on cuDNN under
  ``torch.profiler`` with ``record_shapes``: each weight-gradient
  kernel's device ms a step put down to the input and weight shapes of
  its ``aten::convolution_backward``, and the step's kernels by name on
  both paths;
* ``shape``: each layer's weight gradient alone, in turns (cuDNN,
  split-K, split-K, cuDNN), then with ``cudnn.benchmark``, CUDA-event ms
  a call and the split-K result's rel-l2 against cuDNN's;
* ``sweep``: the split-K's ms a step over the 3-D layers (weighted by
  their calls) for chunk budgets and tile targets;
* ``steps``: the training step on cuDNN's weight gradients and on this
  path in turns, host ms a step and peak memory; ``determinism``: two
  steps' gradients from one state, bitwise, and this path's against
  cuDNN's.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CELL = "dtu_train-b4"
KINDS = ("conv2d", "conv3d", "conv_transpose3d")


def log(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


@contextlib.contextmanager
def old_path(conv_wgrad):
    """Every convolution through plain autograd (cuDNN's weight
    gradient)."""
    saved = conv_wgrad.applies
    conv_wgrad.applies = lambda x, w: False
    try:
        yield
    finally:
        conv_wgrad.applies = saved


def session(torch, seed):
    from portbench.lib import registry
    from portbench.run import Context
    from portbench.traffic import train_closed
    wl = registry.workload(CELL)
    cfg = registry.config(wl["config"])
    return train_closed.Session(Context(wl, cfg, seed,
                                        torch.device("cuda")))


def layers(torch, sess):
    """{spec: {'calls', 'modules'}} of the convolutions whose weight
    trains, from one forward and backward of the plain kernels' path
    (the GRU's convolutions run in its module's forward there).  A spec
    is (kind, input shape (N, *spatial, C), weight shape, stride,
    padding, output padding), kind ``conv2d``, ``conv3d`` or
    ``conv_transpose3d``."""
    import chip_smoke
    from effi_mvs_plus_tpu_torch import nn
    from effi_mvs_plus_tpu_torch.ops import cuda_conv, cuda_gru, cuda_warp
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss
    model = sess.model
    stack, found = [], collections.OrderedDict()
    names = {m: n for n, m in model.named_modules()}

    def enter(m, args):
        stack.append(names[m])

    def leave(m, args, out):
        stack.pop()
    hooks = [m.register_forward_pre_hook(enter) for m in model.modules()]
    hooks += [m.register_forward_hook(leave) for m in model.modules()]
    saved = {k: getattr(nn, k) for k in KINDS}

    def hooked(kind):
        def conv(x, w, b=None, stride=1, padding=0, output_padding=0):
            if w.requires_grad and torch.is_grad_enabled():
                n = x.dim() - 2
                key = (kind, tuple(x.shape), tuple(w.shape),
                       tup(stride, n), tup(padding, n),
                       tup(output_padding, n))
                e = found.setdefault(key, {"calls": 0, "modules": []})
                e["calls"] += 1
                where = stack[-1] if stack else "(backward)"
                if where not in e["modules"]:
                    e["modules"].append(where)
            args = (x, w, b, stride, padding)
            if kind == "conv_transpose3d":
                args += (output_padding,)
            return saved[kind](*args)
        return conv
    for k in KINDS:
        setattr(nn, k, hooked(k))
    try:
        batch = T.batch_to_device(sess.pool[0], sess.ctx.device)
        with chip_smoke.plain_kernels(cuda_warp, cuda_gru, cuda_conv):
            model.train()
            out = model(batch["imgs"], batch["proj_matrices"],
                        batch["depth_values"])
            loss, _ = mvs_loss(out["depth"], batch["depth"], batch["mask"])
            loss.backward()
        model.zero_grad(set_to_none=True)
    finally:
        for k, f in saved.items():
            setattr(nn, k, f)
        for h in hooks:
            h.remove()
    return found


def tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def kernels_of(evt):
    out = list(getattr(evt, "kernels", []) or [])
    for c in getattr(evt, "cpu_children", []) or []:
        out += kernels_of(c)
    return out


def kernel_us(k):
    return float(getattr(k, "duration", 0) or 0)


def profiled_steps(torch, sess, n, shapes):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        sess.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        for _ in range(n):
            sess.step()
        torch.cuda.synchronize()
    return prof


def by_kernel(prof, n, top=25):
    tot = collections.Counter()
    for e in prof.key_averages():
        dt = getattr(e, "device_type", None)
        if dt is not None and str(dt).endswith("CUDA"):
            tot[e.key] += (getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0)) / 1e3
    return [[k[:90], round(v / n, 3)] for k, v in tot.most_common(top)]


def attribution(torch, sess, n=3):
    """cuDNN's weight-gradient kernels a step, by the shape of their
    convolution_backward: {(input shape, weight shape): {kernel: ms}}."""
    prof = profiled_steps(torch, sess, n, True)
    per = collections.defaultdict(collections.Counter)
    for evt in prof.events():
        if evt.name != "aten::convolution_backward":
            continue
        shp = evt.input_shapes
        key = f"in {shp[1]} w {shp[2]}" if shp and len(shp) > 2 else "?"
        for k in kernels_of(evt):
            if "wgrad" in k.name.lower() or "grad_filter" in k.name.lower() \
                    or "bwd_filter" in k.name.lower():
                per[key][k.name[:60]] += kernel_us(k) / 1e3 / n
    return per, by_kernel(prof, n)


def event_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def shape_inputs(torch, key, gen):
    """x, w and an output gradient g of a spec, channels-last memory
    viewed channels-first as ``nn`` hands them to cuDNN."""
    import torch.nn.functional as F
    kind, xs, ws, stride, padding, opad = key
    dev = gen.device
    x = torch.randn(xs, device=dev, generator=gen).movedim(-1, 1)
    w = torch.randn(ws, device=dev, generator=gen)
    fn = {"conv2d": F.conv2d, "conv3d": F.conv3d}.get(kind)
    y = fn(x, w, None, stride, padding) if fn else F.conv_transpose3d(
        x, w, None, stride, padding, opad)
    g = torch.randn(y.movedim(1, -1).shape, device=dev,
                    generator=gen).movedim(-1, 1)
    return x, w, g


def wgrads(torch, key, x, w, g):
    """(cuDNN's weight gradient, the split-K's) as callables."""
    from effi_mvs_plus_tpu_torch.ops import conv_wgrad
    kind, _, ws, stride, padding, opad = key
    t = kind == "conv_transpose3d"

    def cudnn():
        return torch.ops.aten.convolution_backward(
            g, x, w, None, stride, padding, (1,) * len(stride), t,
            opad if t else (0,) * len(stride), 1, (False, True, False))[1]

    def splitk(**kw):
        a, b = x.movedim(1, -1), g.movedim(1, -1)
        if t:
            a, b = b, a
        return conv_wgrad.weight_grad(a, b, ws[2:], stride, padding, **kw)
    return cudnn, splitk


def shape_timings(torch, found, reps=5, device="cuda"):
    from effi_mvs_plus_tpu_torch.ops import conv_wgrad
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for key, e in found.items():
        x, w, g = shape_inputs(torch, key, gen)
        cudnn, splitk = wgrads(torch, key, x, w, g)
        a1, _ = event_ms(torch, cudnn, reps)
        b1, host = event_ms(torch, splitk, reps)
        b2, _ = event_ms(torch, splitk, reps)
        a2, _ = event_ms(torch, cudnn, reps)
        want, got = cudnn().double(), splitk().double()
        rel = float((got - want).norm() / want.norm())
        bitwise = bool(torch.equal(splitk(), splitk()))
        torch.backends.cudnn.benchmark = True
        try:
            c, _ = event_ms(torch, cudnn, reps)
        finally:
            torch.backends.cudnn.benchmark = False
        kind, xs, ws, stride, padding, opad = key
        t = kind == "conv_transpose3d"
        big = x if t else g                  # the GEMM's positions
        P = big.numel() // big.shape[1]
        flop = 2 * P * math.prod(ws)
        gl = (x if t else g).movedim(1, -1)
        xl = (g if t else x).movedim(1, -1)
        rows.append({"key": [kind, list(xs), list(ws), list(stride),
                             list(padding), list(opad)],
                     "calls": e["calls"], "modules": e["modules"],
                     "gflop": flop / 1e9, "plan": conv_wgrad.plan(
                         xl.shape[0], list(gl.shape[1:-1]), xl.shape[-1],
                         gl.shape[-1], ws[2:], stride),
                     "cudnn_ms": [round(a1, 4), round(a2, 4)],
                     "splitk_ms": [round(b1, 4), round(b2, 4)],
                     "splitk_host_ms": round(host, 4),
                     "cudnn_benchmark_ms": round(c, 4),
                     "rel_l2": rel, "bitwise": bitwise})
        del x, g, w
    return rows


def sweep(torch, found, budgets, blocks, reps=3, device="cuda"):
    from effi_mvs_plus_tpu_torch.ops import conv_wgrad
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    found = {k: e for k, e in found.items() if k[0] != "conv2d"}
    fns = {k: wgrads(torch, k, *shape_inputs(torch, k, gen))[1]
           for k in found}
    saved = conv_wgrad.BLOCKS
    out = []
    try:
        for budget in budgets:
            for nb in blocks:
                conv_wgrad.BLOCKS = nb
                total = host = 0.0
                for key, e in found.items():
                    ms, h = event_ms(torch, lambda: fns[key](budget=budget),
                                     reps)
                    total += ms * e["calls"]
                    host += h * e["calls"]
                out.append({"budget_mb": budget >> 20, "blocks": nb,
                            "ms_a_step": round(total, 3),
                            "host_ms_a_step": round(host, 3)})
    finally:
        conv_wgrad.BLOCKS = saved
    return out


def timed_steps(torch, sess, n):
    for _ in range(2):
        sess.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        sess.step()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n * 1e3,
            torch.cuda.max_memory_allocated())


def step_grads(torch, sess, saved):
    from effi_mvs_plus_tpu_torch import nn
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss
    model = sess.model
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    model.train()
    gen = torch.Generator(device=sess.ctx.device)
    gen.manual_seed(7)
    nn.use_generator(model, gen)
    batch = T.batch_to_device(sess.pool[1], sess.ctx.device)
    out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    loss, _ = mvs_loss(out["depth"], batch["depth"], batch["mask"])
    loss.backward()
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--out", default="")
    ap.add_argument("--skip", default="", help="comma list of parts")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    import torch
    import chip_smoke
    from effi_mvs_plus_tpu_torch.ops import conv_wgrad
    from effi_mvs_plus_tpu_torch.utils import profiling
    out = args.out
    log({"part": "device", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": chip_smoke.nvidia_smi(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "chunk_bytes": conv_wgrad.CHUNK_BYTES,
         "blocks": conv_wgrad.BLOCKS}, out)
    sess = session(torch, args.seed)
    found = layers(torch, sess)
    log({"part": "layers", "distinct": collections.Counter(
        k[0] for k in found), "calls": collections.Counter(
        {kind: sum(e["calls"] for k, e in found.items() if k[0] == kind)
         for kind in KINDS}), "layers": [[k, e["calls"], e["modules"]]
                                         for k, e in found.items()]}, out)
    if "attribution" not in skip:
        with old_path(conv_wgrad):
            per, kern_old = attribution(torch, sess)
        log({"part": "attribution", "per_shape": {
            k: {n: round(v, 3) for n, v in c.items()}
            for k, c in per.items()}, "kernels_old": kern_old}, out)
        prof = profiled_steps(torch, sess, 3, False)
        log({"part": "kernels_new", "kernels": by_kernel(prof, 3)}, out)
        del prof
    if "shapes" not in skip:
        rows = shape_timings(torch, found)
        for r in rows:
            log({"part": "shape", **r}, out)
        for kind in KINDS:
            sel = [r for r in rows if r["key"][0] == kind]
            tot = {m: sum(statistics.mean(r[m]) * r["calls"] if isinstance(
                r[m], list) else r[m] * r["calls"] for r in sel)
                for m in ("cudnn_ms", "splitk_ms", "cudnn_benchmark_ms",
                          "splitk_host_ms")}
            log({"part": "shapes_total_ms_a_step", "kind": kind, **tot}, out)
    if "sweep" not in skip:
        log({"part": "sweep", "rows": sweep(
            torch, found, [32 << 20, 64 << 20, 128 << 20, 256 << 20],
            [528, 1056, 2112])}, out)
    if "steps" not in skip:
        res = collections.defaultdict(list)
        for turn in ("old", "new", "new", "old"):
            if turn == "old":
                with old_path(conv_wgrad):
                    ms, peak = timed_steps(torch, sess, 10)
            else:
                n0 = profiling.counter("conv_wgrad.calls")
                b0 = profiling.counter("conv_wgrad.patch_bytes")
                ms, peak = timed_steps(torch, sess, 10)
                res["calls_a_step"].append(
                    (profiling.counter("conv_wgrad.calls") - n0) / 12)
                res["patch_bytes_a_step"].append(
                    (profiling.counter("conv_wgrad.patch_bytes") - b0) / 12)
            res[turn + "_ms"].append(round(ms, 2))
            res[turn + "_peak"].append(peak)
        for budget in (64 << 20, 256 << 20):
            saved = conv_wgrad.CHUNK_BYTES
            conv_wgrad.CHUNK_BYTES = budget
            try:
                ms, peak = timed_steps(torch, sess, 4)
            finally:
                conv_wgrad.CHUNK_BYTES = saved
            res[f"new_{budget >> 20}mb"] = [round(ms, 2), peak]
        log({"part": "steps", **res}, out)
    if "determinism" not in skip:
        saved = {k: v.clone() for k, v in sess.model.state_dict().items()}
        det = {}
        for det_cudnn in (False, True):
            torch.backends.cudnn.deterministic = det_cudnn
            try:
                la, ga = step_grads(torch, sess, saved)
                lb, gb = step_grads(torch, sess, saved)
                with old_path(conv_wgrad):
                    lo, go = step_grads(torch, sess, saved)
            finally:
                torch.backends.cudnn.deterministic = False
            rels = chip_smoke.grad_rels(ga, go)
            det[f"cudnn_deterministic_{det_cudnn}"] = {
                "bitwise_leaves": sum(torch.equal(ga[n], gb[n]) for n in ga),
                "leaves": len(ga), "loss_new": la, "loss_new2": lb,
                "loss_old": lo,
                "not_bitwise": [n for n in ga
                                if not torch.equal(ga[n], gb[n])],
                "new_vs_old_worst": rels[-1], "new_vs_old_p90":
                rels[int(0.9 * len(rels))][0],
                "new_vs_old_median": rels[len(rels) // 2][0]}
        log({"part": "determinism", **det}, out)
    log({"part": "done"}, out)


if __name__ == "__main__":
    main()
