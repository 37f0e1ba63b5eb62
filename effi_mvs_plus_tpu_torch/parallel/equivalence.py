"""The equivalence gate of the multi-process layouts.

A sharded training step must compute what one process computes on the
whole batch.  As the JAX package's gate (``__graft_entry__.py``
``dryrun_multichip``), one step from the same weights, batch and random
stream (dropout on) runs unsharded and under each layout, and the
sharded result must hold |Δloss| <= 1e-4 (1 + |loss|) and, after the
AdamW step, max |Δ| <= 2.5e-3 over every parameter and BN running
statistic (Adam moves a weight by about lr·sign(g) whatever |g| is, so a
near-zero gradient summed in another order may move it up to 2 lr the
other way).  For the same reason a gradient summed twice over a group
would pass that check, so the gradients AdamW took are held too: every
leaf within rel-l2 5e-2 of the single process's (the training path's
gradient bound, ``tests/test_torch_train.py``).  The view-sharded
engine's maps must equal the unsharded engine's within the fp32 map
tolerance: max depth error under 0.5% of the map's range plus 0.5 mm,
confidence within 5e-3.

The layouts (``LAYOUTS``) are the data axis, the source views, the
cost volume's hypotheses (``depth``, and ``views_depth``, the JAX CLI's
default) and the image rows (``spatial``, ``views_spatial``) over the
model axis, and their combinations (``depth_spatial``,
``views_depth_spatial``, ``data_depth_spatial``, ``depth_spatial4``: the
2-D activations by rows, the volumes by hypotheses).  A layout may take
a batch of its own height (``ROW_HEIGHTS``: four row blocks need more
rows than the gate's 64, and ``spatial_uneven`` splits 96 rows as
32 + 64), held
against the single process's step on that batch (``references``).
``engine`` and ``engine_spatial`` are the view- and row-sharded engines'
maps.

``spawn`` runs the layouts in ``world`` processes (``torch.multiprocessing``
with the spawn start method, rendezvous on ``tcp://localhost``), each
rank on ``rank_device(device)`` (cuda unless told otherwise); the CPU
tests pass ``device="cpu"`` and use gloo, and two ranks
that share one GPU use gloo on CUDA tensors (NCCL refuses them).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import numpy as np
import torch

from effi_mvs_plus_tpu_torch.data import cams as camio

LOSS_RTOL = 1e-4
PARAM_ATOL = 2.5e-3
GRAD_REL = 5e-2
# name: (data ranks, model ranks, model-axis layouts)
LAYOUTS = {"data": (2, 1, "views"), "views": (1, 2, "views"),
           "data_views": (2, 2, "views"), "depth": (1, 2, "depth"),
           "views_depth": (1, 2, "views,depth"),
           "data_views_depth": (2, 2, "views,depth"),
           "depth4": (1, 4, "depth"), "spatial": (1, 2, "spatial"),
           "views_spatial": (1, 2, "views,spatial"),
           "data_spatial": (2, 2, "spatial"),
           "spatial4": (1, 4, "spatial"),
           "spatial_uneven": (1, 2, "spatial"),
           "depth_spatial": (1, 2, "depth,spatial"),
           "views_depth_spatial": (1, 2, "views,depth,spatial"),
           "data_depth_spatial": (2, 2, "depth,spatial"),
           "depth_spatial4": (1, 4, "depth,spatial")}
# image rows of the layouts that take a batch of their own height: 128
# rows give four ranks 32 each (stage 1: 4 + 4 + 4 + 4), 96 rows two
# unequal blocks (stage 1: 4 + 8)
ROW_HEIGHTS = {"spatial4": 128, "spatial_uneven": 96, "depth_spatial4": 128}
# the engines of the model-axis layouts: name -> InferenceEngine's
# shard_policy
ENGINES = {"engine": "views", "engine_spatial": "spatial"}


def rig(B, V, H, W):
    """The seeded rig of the JAX package's gate (``__graft_entry__``
    ``_tiny_inputs``): noise images, the reference camera at the origin,
    sources yawed by 0.03 rad a view and shifted (20, 5, 3) a view,
    quarter-resolution focal 30, 384 inverse depths from 425 mm."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)
    intr_q = np.array([[30.0, 0, W / 8], [0, 30.0, H / 8], [0, 0, 1]],
                      np.float32)
    exts = [np.eye(4, dtype=np.float32)]
    for v in range(1, V):
        E = np.eye(4, dtype=np.float32)
        a = 0.03 * v
        c, s = np.cos(a), np.sin(a)
        E[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        E[:3, 3] = [20.0 * v, 5.0 * v, 3.0 * v]
        exts.append(E)
    projs = [camio.stage_proj_matrices(E, intr_q) for E in exts]
    proj_ms = {k: np.broadcast_to(np.stack([p[k] for p in projs])[None],
                                  (B, V, 2, 4, 4)).copy()
               for k in ("stage1", "stage2", "stage3")}
    dv = np.broadcast_to(camio.inverse_depth_values(
        425.0, 2.5 * 0.53, 384)[None], (B, 384)).copy()
    return imgs, proj_ms, dv


def train_batch(B=2, V=3, H=64, W=96):
    """The gate's training batch: the rig, ground truth uniform in
    430-930 mm and a random 70% mask (the JAX gate's, seed 1)."""
    imgs, proj_ms, dv = rig(B, V, H, W)
    rng = np.random.default_rng(1)
    scales = {"stage1": 8, "stage2": 4, "stage3": 2, "stage4": 1}
    gt = {k: rng.uniform(430, 930, (B, H // s, W // s)).astype(np.float32)
          for k, s in scales.items()}
    mask = {k: (rng.uniform(0, 1, v.shape) > 0.3).astype(np.float32)
            for k, v in gt.items()}
    return {"imgs": imgs, "proj_matrices": proj_ms, "depth_values": dv,
            "depth": gt, "mask": mask}


def rows(batch, start, stop):
    """Rows [start, stop) of every array of a batch pytree."""
    if isinstance(batch, dict):
        return {k: rows(v, start, stop) for k, v in batch.items()}
    return batch[start:stop]


@contextlib.contextmanager
def memory_phases(model, device, out):
    """Fill ``out`` with where one training step's memory goes:
    ``saved_gib``, the bytes the forward saves for the backward by the
    model's top-level module that saved them (a storage counted once, at
    its first save); on the card also ``forward_peak_gib`` and
    ``after_forward_gib`` (the peak and the memory in use when the
    backward starts, at its first use of a saved tensor) and
    ``step_peak_gib`` (the whole step's peak), from the peak reset by the
    caller.  The hooks return every tensor as given."""
    cuda = device.type == "cuda"
    seen, saved, where = set(), {}, ["other"]
    forward = [True]

    def enter(name):
        return lambda mod, args: where.append(name)

    def leave(mod, args, output):
        where.pop()

    handles = []
    for name, child in model.named_children():
        handles += [child.register_forward_pre_hook(enter(name)),
                    child.register_forward_hook(leave)]

    def pack(t):
        st = t.untyped_storage()
        if forward[0] and (st.data_ptr(), st.device) not in seen:
            seen.add((st.data_ptr(), st.device))
            saved[where[-1]] = saved.get(where[-1], 0) + st.nbytes()
        return t

    def unpack(t):
        if forward[0]:
            forward[0] = False
            if cuda:
                out["forward_peak_gib"] = (
                    torch.cuda.max_memory_allocated(device) / 2 ** 30)
                out["after_forward_gib"] = (
                    torch.cuda.memory_allocated(device) / 2 ** 30)
        return t

    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        for h in handles:
            h.remove()
    out["saved_gib"] = {k: v / 2 ** 30 for k, v in sorted(
        saved.items(), key=lambda kv: -kv[1])}
    if cuda:
        out["step_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30


def train_step(state, cfg, batch, device, policy=None, lr=1e-3, seed=0,
               memory=None):
    """One ``make_train_step`` step from ``state`` on this rank's rows of
    the global ``batch``; (loss, state dict, the gradients AdamW took),
    on the CPU.  ``memory``: a dict that ``memory_phases`` fills."""
    from effi_mvs_plus_tpu_torch.models import EffiMVS
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
    model = EffiMVS(cfg)
    model.load_state_dict(state, strict=True)
    model.to(device)
    opt, sched, _ = make_optimizer(model, lr, 100)
    step = T.make_train_step(model, opt, sched, seed=seed, device=device,
                             policy=policy)
    if policy is not None and policy.mesh.data > 1:
        n = batch["imgs"].shape[0] // policy.mesh.data
        batch = rows(batch, n * policy.mesh.data_rank,
                     n * (policy.mesh.data_rank + 1))
    with memory_phases(model, torch.device(device), memory if memory
                       is not None else {}):
        loss = float(step(batch)["loss"])
    return (loss, {k: v.detach().cpu() for k, v in model.state_dict().items()},
            {k: p.grad.cpu() for k, p in model.named_parameters()})


def engine_maps(state, cfg, batch, device, shard_policy=None):
    """The engine's (depth, conf) of one request, as numpy, with
    ``shard_policy`` (``InferenceEngine``)."""
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    eng = InferenceEngine(state, cfg, device=device,
                          shard_policy=shard_policy)
    return eng.infer_batch(batch)


def step_deltas(ref, got):
    """A sharded step (loss, state, gradients) against the single
    process's: |Δloss|, max |Δ| over the state's floating entries (an
    integer entry that differs reads inf) and the rel-l2 of every
    gradient leaf, with the worst leaf's reference norm beside the
    median leaf's (a leaf whose gradient is near zero reads a large
    rel-l2 from any change of summation order)."""
    (ref_loss, ref_sd, ref_g), (loss, sd, g) = ref, got
    dmax = 0.0
    for k, want in ref_sd.items():
        if want.is_floating_point():
            dmax = max(dmax, float((sd[k] - want).abs().max()))
        elif not torch.equal(sd[k], want):
            dmax = float("inf")
    rels = {}
    for k, want in ref_g.items():
        norm = float(want.norm())
        rels[k] = float((g[k] - want).norm()) / norm if norm else float(
            g[k].abs().max())
    worst = max(rels, key=rels.get)
    norms = sorted(float(v.norm()) for v in ref_g.values())
    return {"loss": loss, "dloss": abs(loss - ref_loss), "max_dparam": dmax,
            "grad_worst_rel_l2": rels[worst], "grad_worst_leaf": worst,
            "grad_worst_ref_norm": float(ref_g[worst].norm()),
            "grad_median_ref_norm": norms[len(norms) // 2],
            "grad_rel_l2": rels}


def check_step(tag, ref_loss, d):
    """Hold ``step_deltas``' readings ``d`` to the gate's bounds."""
    if not (np.isfinite(d["loss"])
            and d["dloss"] <= LOSS_RTOL * (1 + abs(ref_loss))):
        raise AssertionError(f"{tag}: loss {d['loss']} against the single "
                             f"process's {ref_loss}")
    if not d["max_dparam"] <= PARAM_ATOL:
        raise AssertionError(f"{tag}: state after the step differs by "
                             f"{d['max_dparam']:.3e} (bound {PARAM_ATOL})")
    if not d["grad_worst_rel_l2"] < GRAD_REL:
        raise AssertionError(f"{tag}: gradient {d['grad_worst_leaf']} "
                             f"rel-l2 {d['grad_worst_rel_l2']:.3e}")


def map_deltas(ref, got):
    """Depth and confidence of a sharded engine against the unsharded
    one: worst depth error over the fp32 map tolerance (0.5% of the range
    + 0.5 mm) and max confidence error."""
    (d0, c0), (d1, c1) = ref, got
    tol = 0.005 * float(d0.max() - d0.min()) + 0.5
    return {"depth_err_over_tolerance": float(np.abs(d1 - d0).max()) / tol,
            "conf_max_abs": float(np.abs(c1 - c0).max())}


def check_maps(tag, d):
    if not (d["depth_err_over_tolerance"] < 1 and d["conf_max_abs"] < 5e-3):
        raise AssertionError(f"{tag}: {d}")


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _each_rank(value, world):
    """Every rank's ``value``, in rank order, on every rank (an all_reduce
    of zero-padded slots)."""
    from effi_mvs_plus_tpu_torch import parallel
    slots = torch.zeros(world, dtype=torch.float64,
                        device=parallel.distributed.comm_device())
    slots[parallel.rank()] = value
    torch.distributed.all_reduce(slots)
    return slots.tolist()


def _rank_main(rank, world, port, backend, device, job):
    """One process of ``spawn``: ``job["setup"]`` (if any), then the
    layouts of ``job`` in turn, each read against the references in
    ``job["ref"]``; rank 0 writes the readings to ``job["out"]``."""
    from effi_mvs_plus_tpu_torch import parallel
    torch.set_num_threads(job["threads"])
    parallel.initialize(backend=backend, device=device,
                        init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
    dev = parallel.rank_device(device)
    if dev.type == "cuda":
        from effi_mvs_plus_tpu_torch.device import resolve_device
        resolve_device(dev)
    if job["setup"] is not None:
        job["setup"]()
    from effi_mvs_plus_tpu_torch.utils import profiling

    def launches():
        return {k: profiling.counter(f"{k}.launches")
                for k in ("k1", "k2", "k3", "k4")}
    ref = torch.load(job["ref"], weights_only=False)
    state, cfg, batch = ref["state"], ref["cfg"], ref["batch"]
    report = {"world": world, "backend": torch.distributed.get_backend(),
              "device": str(dev)}
    for name in job["layouts"]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        n0 = launches()
        if name in ENGINES:
            got = engine_maps(state, ref["request_cfg"], ref["request"], dev,
                              ENGINES[name])
            report[name] = map_deltas(ref["maps"], got)
        else:
            data, model, kinds = job["specs"].get(name) or LAYOUTS[name]
            pol = parallel.make_policy(parallel.make_mesh(data, model), kinds)
            memory = {}
            report[name] = step_deltas(
                ref["steps"].get(name, ref["step"]),
                train_step(state, cfg, ref["batches"].get(name, batch), dev,
                           pol, memory=memory))
            report[name]["memory"] = memory
        report[name]["seconds"] = time.perf_counter() - t0
        report[name]["launches"] = {k: v - n0[k]
                                    for k, v in launches().items()}
        if dev.type == "cuda":
            report[name]["peak_gib"] = _each_rank(
                torch.cuda.max_memory_allocated(dev) / 2 ** 30, world)
        parallel.barrier()
    # rank 0 alone writes, as the CLIs' checkpoints
    if parallel.is_main():
        with open(job["out"], "w") as f:
            json.dump(report, f)
    parallel.barrier()
    torch.distributed.destroy_process_group()


def references(state, cfg, batch, device, request=None, request_cfg=None,
               batches=None):
    """The single process's step on ``batch`` and, given a ``request``,
    the engine's maps (at ``request_cfg``, else ``cfg``): the references
    of ``spawn``.  ``batches``: layout name -> a batch of its own (a
    height of ``ROW_HEIGHTS``), with the single process's step on each;
    ``memory``: the main step's ``memory_phases``."""
    batches = dict(batches or {})
    memory = {}
    ref = {"state": state, "cfg": cfg, "batch": batch,
           "step": train_step(state, cfg, batch, device, memory=memory),
           "memory": memory,
           "batches": batches,
           "steps": {k: train_step(state, cfg, b, device)
                     for k, b in batches.items()}}
    if request is not None:
        rcfg = request_cfg or cfg
        ref.update(request=request, request_cfg=rcfg,
                   maps=engine_maps(state, rcfg, request, device))
    return ref


def spawn(world, layouts, ref, workdir, device="cuda", backend=None,
          timeout=120.0, threads=2, setup=None, check=True, specs=None):
    """Run ``layouts`` (names of ``LAYOUTS`` whose grid has ``world``
    ranks, of ``specs``, a dict of more such (data, model, layouts)
    entries, or of ``ENGINES``) in ``world`` processes on ``device`` against
    ``ref`` (``references``); returns rank 0's readings, held to the
    gate's bounds unless ``check`` is False.  ``backend`` defaults to the
    device's (``initialize``); ``setup``, a picklable callable, runs in
    every rank before the layouts.  A rank that fails, or a run past
    ``timeout`` seconds, raises."""
    import torch.multiprocessing as mp
    ref_path = os.path.join(workdir, f"ref_{world}.pt")
    torch.save(ref, ref_path)
    job = {"ref": ref_path, "layouts": list(layouts), "threads": threads,
           "setup": setup, "specs": dict(specs or {}),
           "out": os.path.join(workdir, f"report_{world}.json")}
    ctx = mp.start_processes(_rank_main,
                             args=(world, free_port(), backend, device, job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks ran past {timeout} s")
    with open(job["out"]) as f:
        report = json.load(f)
    if check:
        for name in layouts:
            if name in ENGINES:
                check_maps(name, report[name])
            else:
                check_step(name, ref["steps"].get(name, ref["step"])[0],
                           report[name])
    return report
