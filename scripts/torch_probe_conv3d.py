"""The serving forward's 3-D cost regularisation on the card: which
layers cuDNN's 3-D kernels and the elementwise passes after them serve,
and what each 3-D layer of ``CostRegNet`` and ``CSPBlock`` costs through
the layer-by-layer path (cuDNN, BN, ReLU, the residual add, the cat) and
through ``ops/cuda_conv3d.py``'s fused kernel, against its bound.

    python3 scripts/torch_probe_conv3d.py [--cells A,B] [--seed N]
        [--batches 3] [--reps 10] [--out FILE]

Needs one CUDA GPU; imports nothing of JAX.  For each serving cell
(``dtu_eval-b6``: 1600x1184, B=6, bf16; ``tnt_eval_fp32-b2``: 1920x1056,
B=2, fp32 with TF32 off) it builds the cell's own session
(``portbench``'s traffic kind: the ``InferenceEngine`` on the shipped
weights, the rendered pool) and prints one JSON object a line:

* ``layers``: the 3-D layer calls of one forward (module, input and
  output shapes), with their GFLOP, their bytes fused (each input and
  residual read once, each output written once) and their bound (bytes
  over 3.35 TB/s or FLOPs over the dtype's peak, the larger);
* ``attribution`` (path ``layers``, the parent's, and ``fused``):
  ``--batches`` engine batches under ``torch.profiler`` with
  ``record_shapes``, every device kernel put on the innermost 3-D layer
  or module whose forward launched it (a forward hook opens a
  ``record_function`` range around each), else on ``outside`` (the 2-D
  layers, the warps, the GRU, the copies): ms a batch by owner and
  class, the 3-D kernels by name, ``conv3d_reg.launches`` a forward;
* ``layer``: each 3-D layer alone at the cell's shape, in turns
  (layers, fused, fused, layers, then the fused layer's plain version
  ``_reg_torch``), CUDA-event ms a call and a batch, against its bound;
  then the sums over a forward.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
CELLS = ("tnt_eval_fp32-b2", "dtu_eval-b6")
RANGE = "probe3d:"


def log(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


@contextlib.contextmanager
def layer_path(blocks):
    """The 3-D modules layer by layer (the parent's path)."""
    saved = blocks.reg_applies
    blocks.reg_applies = lambda x, training: False
    try:
        yield
    finally:
        blocks.reg_applies = saved


def session(torch, cell, seed):
    from portbench.lib import registry
    from portbench.run import Context
    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    kind = registry.traffic(wl["kind"])
    return kind.Session(Context(wl, cfg, seed, torch.device("cuda")))


def modules_3d(model):
    """{module: name} of the 3-D modules and their layers."""
    from effi_mvs_plus_tpu_torch.models import blocks
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (blocks.CostRegNet, blocks.CSPBlock)):
            out[m] = name
            for attr in m.LAYERS:
                out[getattr(m, attr)] = f"{name}.{attr}"
    return out


@contextlib.contextmanager
def ranges(torch, model, record=None):
    """A ``record_function`` range around each 3-D module's and layer's
    forward; with ``record``, each layer call's (name, input shapes,
    output shape) appended to it."""
    from torch.profiler import record_function
    names = modules_3d(model)
    open_ = {}

    def enter(m, args):
        rf = record_function(RANGE + names[m])
        rf.__enter__()
        open_.setdefault(m, []).append(rf)

    def leave(m, args, out):
        open_[m].pop().__exit__(None, None, None)
        if record is not None and "." in names[m]:
            y = out[0] if isinstance(out, tuple) else out
            record.append((names[m], [list(a.shape) for a in args
                                      if torch.is_tensor(a)],
                           list(y.shape), str(y.dtype)))
    hooks = [m.register_forward_pre_hook(enter) for m in names]
    hooks += [m.register_forward_hook(leave) for m in names]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def layer_calls(torch, sess, blocks):
    """[(layer name, input shapes, output shape, dtype)] of one forward on
    the layer-by-layer path (the fused path runs no layer's forward)."""
    rec = []
    with layer_path(blocks), ranges(torch, sess.engine.model, rec):
        sess.engine.infer_batch(sess.pool[0])
    return rec


def spec_of(model, name):
    """(module, layer) of a layer's dotted name."""
    mod_name, attr = name.rsplit(".", 1)
    mod = dict(model.named_modules())[mod_name]
    return mod, attr


def work(layer, in_shapes, out_shape, dtype, res):
    """(GFLOP, bytes fused, bound ms) of one layer call."""
    from portbench.lib.counts import bound_s
    esize = 2 if dtype == "torch.bfloat16" else 4
    ci, co = layer.channels
    taps = 27 / math.prod(layer.stride) if layer.transpose else 27
    out_vox = math.prod(out_shape[:-1]) if out_shape[-1] == co \
        else math.prod(out_shape)
    flops = 2 * out_vox * co * ci * taps
    nbytes = esize * (sum(math.prod(s) for s in in_shapes)
                      + out_vox * co * (2 if res else 1))
    name = "bfloat16" if esize == 2 else "float32"
    return flops / 1e9, nbytes, bound_s(nbytes, flops, name) * 1e3


def residual_of(name):
    """The layer whose output ``name``'s residual adds (CostRegNet)."""
    return {"conv6": "conv3", "conv7": "conv1"}.get(name.rsplit(".", 1)[1])


def owner_table(torch, prof, n):
    """{owner: {class: ms a batch}}, {owner: {kernel: ms a batch}}: every
    kernel on the innermost probe range around the op that launched it."""
    from torch_profile_dtu import classify
    by_class = collections.defaultdict(collections.Counter)
    by_name = collections.defaultdict(collections.Counter)

    def walk(evt, owner):
        if evt.name.startswith(RANGE):
            owner = evt.name[len(RANGE):]
        for k in getattr(evt, "kernels", []) or []:
            ms = float(getattr(k, "duration", 0) or 0) / 1e3 / n
            by_class[owner][classify(k.name)] += ms
            by_name[owner][k.name[:100]] += ms
        for c in getattr(evt, "cpu_children", []) or []:
            walk(c, owner)
    for evt in prof.events():
        if getattr(evt, "cpu_parent", None) is None:
            walk(evt, "outside")
    return by_class, by_name


def attribution(torch, sess, n, profiling):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        sess.engine.infer_batch(sess.pool[0])
    torch.cuda.synchronize()
    n0 = profiling.counter("conv3d_reg.launches")
    with ranges(torch, sess.engine.model), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        for i in range(n):
            sess.engine.infer_batch(sess.pool[i % len(sess.pool)])
        torch.cuda.synchronize()
    launches = (profiling.counter("conv3d_reg.launches") - n0) / n
    by_class, by_name = owner_table(torch, prof, n)
    is3d = [o for o in by_class if o != "outside"]
    tot = collections.Counter()
    for o in is3d:
        tot.update(by_class[o])
    names3d = collections.Counter()
    for o in is3d:
        names3d.update(by_name[o])
    # every device kernel by name (the fused kernel launches through
    # ctypes, so no host op owns it in the table above)
    device = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.name[:100]] += (e.time_range.end
                                     - e.time_range.start) / 1e3 / n
    fused_ms = sum(v for k, v in device.items() if "conv3d_reg_kernel" in k)
    return {"launches_a_forward": launches,
            "ms_a_batch_3d_by_class": {k: round(v, 3)
                                       for k, v in tot.items()},
            "ms_a_batch_outside_by_class": {
                k: round(v, 3) for k, v in by_class["outside"].items()},
            "ms_a_batch_by_owner": {o: {k: round(v, 3) for k, v in c.items()}
                                    for o, c in sorted(by_class.items())},
            "kernels_3d": [[k, round(v, 3)]
                           for k, v in names3d.most_common(30)],
            "kernels_outside": [[k, round(v, 3)] for k, v in
                                by_name["outside"].most_common(15)],
            "conv3d_reg_kernel_ms_a_batch": round(fused_ms, 3),
            "device_by_name": {k: round(v, 4) for k, v in device.items()}}


def event_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def layer_timings(torch, sess, calls, reps):
    """Each distinct layer call alone: the layer-by-layer path (the block,
    then the residual add or with the cat before it) against the fused
    kernel, in turns; ms a call and a batch, and its bound."""
    from effi_mvs_plus_tpu_torch.ops import cuda_conv3d
    model = sess.engine.model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    seen = collections.OrderedDict()
    for name, ins, out, dt in calls:
        key = ("CSP" in name, name.rsplit(".", 1)[1],
               tuple(map(tuple, ins)), tuple(out), dt)
        e = seen.setdefault(key, {"calls": 0, "names": []})
        e["calls"] += 1
        e["names"].append(name)
    rows = []
    for (_, attr, ins, out, dt), e in seen.items():
        mod, _ = spec_of(model, e["names"][0])
        block = getattr(mod, attr)
        dtype = getattr(torch, dt.split(".")[1])
        layer = cuda_conv3d.layer(block)
        x = torch.randn(ins[0], device="cuda", generator=gen).to(dtype)
        x2 = res = None
        if attr == "conv1" and "CSP" in e["names"][0]:
            half = list(ins[0][:-1]) + [ins[0][-1] // 2]
            x = torch.randn(half, device="cuda", generator=gen).to(dtype)
            x2 = torch.randn(half, device="cuda", generator=gen).to(dtype)
        if residual_of(e["names"][0]):
            res = torch.randn(out, device="cuda", generator=gen).to(dtype)

        def old():
            xin = x if x2 is None else torch.cat([x, x2], -1)
            y = block(xin)
            y = y if res is None else res + y
            return y[..., 0] if y.shape[-1] == 1 else y

        def new():
            y = cuda_conv3d.conv3d_reg(x, layer, x2, res)
            return y[..., 0] if y.shape[-1] == 1 else y

        def plain():
            return cuda_conv3d._reg_torch(x, layer, x2, res)
        with torch.inference_mode():
            a1 = event_ms(torch, old, reps)
            b1 = event_ms(torch, new, reps)
            b2 = event_ms(torch, new, reps)
            a2 = event_ms(torch, old, reps)
            c = event_ms(torch, plain, reps)
            want, got = old().double(), new().double()
        gflop, nbytes, bound = work(layer, [list(x.shape)] + (
            [list(x2.shape)] if x2 is not None else []), list(out), dt,
            res is not None)
        rows.append({"layer": e["names"], "input": list(ins[0]),
                     "output": list(out), "dtype": dt,
                     "calls_a_batch": e["calls"], "gflop": gflop,
                     "bytes_fused": nbytes, "bound_ms": bound,
                     "layers_ms": [round(a1, 4), round(a2, 4)],
                     "fused_ms": [round(b1, 4), round(b2, 4)],
                     "plain_ms": round(c, 4),
                     "max_abs_gap": float((got - want).abs().max()),
                     "max_abs": float(want.abs().max())})
        del x, x2, res
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--skip", default="", help="comma list of parts")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    import torch
    import chip_smoke
    from effi_mvs_plus_tpu_torch.models import blocks
    from effi_mvs_plus_tpu_torch.utils import profiling
    if not torch.cuda.is_available():
        print("torch_probe_conv3d: no CUDA device", file=sys.stderr)
        return 1
    out = args.out
    log({"part": "device", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": chip_smoke.nvidia_smi(), "torch": torch.__version__,
         "cuda": torch.version.cuda}, out)
    for cell in args.cells.split(","):
        t0 = time.perf_counter()
        sess = session(torch, cell, args.seed)
        calls = layer_calls(torch, sess, blocks)
        log({"part": "layers", "cell": cell, "calls": len(calls),
             "setup_s": round(time.perf_counter() - t0, 1),
             "layers": calls}, out)
        if "attribution" not in skip:
            with layer_path(blocks):
                old = attribution(torch, sess, args.batches, profiling)
            log({"part": "attribution", "cell": cell, "path": "layers",
                 **old}, out)
            new = attribution(torch, sess, args.batches, profiling)
            log({"part": "attribution", "cell": cell, "path": "fused",
                 **new}, out)
            # the kernels the 3-D layers launched on the parent's path, and
            # what is left of each on the fused path (2-D layers share some)
            names3d = {k for k, _ in old["kernels_3d"]}
            log({"part": "kernels_3d_left", "cell": cell, "by_name": {
                k: [old["device_by_name"].get(k, 0.0),
                    new["device_by_name"].get(k, 0.0)] for k in names3d},
                "conv3d_reg_kernel_ms_a_batch": new[
                    "conv3d_reg_kernel_ms_a_batch"]}, out)
        if "layers" not in skip:
            rows = layer_timings(torch, sess, calls, args.reps)
            for r in rows:
                log({"part": "layer", "cell": cell, **r}, out)
            tot = {k: sum(sum(r[k]) / 2 * r["calls_a_batch"] for r in rows)
                   for k in ("layers_ms", "fused_ms")}
            tot["plain_ms"] = sum(r["plain_ms"] * r["calls_a_batch"]
                                  for r in rows)
            tot["bound_ms"] = sum(r["bound_ms"] * r["calls_a_batch"]
                                  for r in rows)
            tot["gflop"] = sum(r["gflop"] * r["calls_a_batch"] for r in rows)
            tot["bytes_fused"] = sum(r["bytes_fused"] * r["calls_a_batch"]
                                     for r in rows)
            tot["fused_share_of_bound"] = tot["bound_ms"] / tot["fused_ms"]
            log({"part": "layers_total_a_batch", "cell": cell,
                 **{k: round(v, 4) for k, v in tot.items()}}, out)
        sess.release()
        del sess
        torch.cuda.empty_cache()
    log({"part": "done"}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
