#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU: serving,
training, the Tanks & Temples reconstruction chain, BlendedMVS
fine-tuning, multi-process parallelism, the device cache and a JAX
training run carried across.

    python3 chip_smoke.py

Needs one CUDA GPU (the kernels are built for sm_90a, an H100) and nvcc;
imports nothing of JAX.  It

1. prints the card's name and power limit (nvidia-smi) and builds the
   kernels from ``effi_mvs_plus_tpu_torch/csrc`` with nvcc;
2. runs K1 (warp + correlate) and K2 (ConvGRU step) at every stage shape
   of the DTU eval config (B=6, 5 views, 1152x864, 48/8/8), of the T&T
   config (B=1, 11 views, 1920x1056, 96/8/8), of the DTU training
   config (B=4, 5 views, 640x512, 48/8/8) and of the BlendedMVS
   fine-tuning config (B=8, 7 views, 768x576, 96/8/8), and K3 (the warp's
   backward) at every stage shape of the DTU training, DTU eval and
   fine-tuning configs, in fp32 and bf16,
   and holds each against its plain PyTorch version on the same inputs
   (K3: autograd of the plain warp; K2: ``_gru_reference``, the TPU
   kernel's rounding points, with r*h rounded to the inputs' dtype; K2
   and K4 in bf16 within the tolerance of the range that rounding gives,
   ``ops/rounding_bounds.py``), with the kernel and plain times from CUDA
   events (K2 and K4 also packing their weights at each call, as a model
   whose weights are not frozen does); K1 (at DTU stages 1 and 2, so
   both its kernels) and K3 also on a rig that projects off the image
   and one that sees hypotheses from behind; K1's
   and K3's entries carry ``window_share``, the share of their texel
   reads (K3: adds) that the shared-memory windows served, from the
   kernels' own counters, and K3's ``global_atomics``, the adds that
   reached device memory (outside the windows, and the windows' flush),
   beside ``atomics``, one a tap and channel (every add of a scatter
   straight into device memory); their ``bound_ms`` counts the source
   texels that the taps reach (``src_texels_tapped``, the share of the
   source maps), and K3's also the write of the whole ``d_src``;
3. drives the serving path: ``InferenceEngine(device="cuda")`` with the
   shipped DTU weights at the DTU eval config answers fp32 and bf16
   requests and writes a scene with ``save_scene_depths``, with the
   kernels' launch counts (K1, K2, K4 and conv3d_reg: 3, 9, 8 and 25 a
   forward) reset just before and read just after; one fp32 request's 13
   depth maps and confidence are held against the same forward with the
   plain versions in place of the kernels;
   and K4 (the fused 3x3 conv + folded BN + ReLU chain of the FPN stem)
   at every chain of both FPNs at the T&T and DTU eval configs, fp32 and
   bf16, on the inputs an inference forward hands it, against its plain
   version, with the unfused cuDNN chain's time beside it; and
   conv3d_reg (``ops/cuda_conv3d.py``: one 3-D layer of CostRegNet or a
   CSP block, conv + BN + ReLU + residual fused) at every layer of both
   modules at the serving cells' shapes (T&T B=2 1920x1056 96/8/8, DTU
   B=6 1600x1184 48/8/8; the CSP blocks at stages 2 and 3), fp32 and
   bf16, against its plain version at the card tests' tolerance, with the
   blocks' time (cuDNN, BN, ReLU, add, cat) beside it;
4. times the DTU eval forward with the fused stem (inference mode) and
   with the unfused blocks (grad mode, parameters frozen), fp32 and bf16,
   in turns;
5. drives the training path: ``train/trainer.py``'s step at the DTU
   training config, fp32, from ``checkpoints/model_dtu.npz``, on seeded
   noise images and plane ground truth through the port's ``Loader``.
   One step's loss and gradients are held against the same step with the
   plain versions, and the step with the kernels is run twice to show the
   run-to-run spread; then timed steps, each launching 3 K1, 3 K3 and 9
   K2 and no conv3d_reg (grad on), with samples/s and peak memory;
6. drives the T&T reconstruction path: renders a textured plane at 1.6 m
   on an 11-view rig at 1920x1056 (focal 1.16 W, band 0.4-3.5 m), runs
   ``cli/test_tank.py``'s ``save_depths`` (``TanksDataset`` -> ``Loader``
   -> ``InferenceEngine(device="cuda")`` with ``model_tank.npz``, 96/8/8,
   bf16) and ``fuse_scene_tank`` (the deployed Horse filter) into a PLY, scores it against the plane with ``eval/dtu.py``,
   and holds one fp32 forward with every kernel against one with every
   plain version; then (``a12``) runs the static and legacy fusion on
   the saved maps on the card and on the CPU and holds the masks and
   values to each other, and times the native data plane's resize of a
   1920x1080 view beside the reader's numpy resize;
7. drives BlendedMVS fine-tuning: renders a textured plane at 768x576
   for 17 cameras into a BlendedMVS tree with its depths, runs
   ``cli/train.py``'s ``main`` with ``--mode finetune`` (the
   blend_finetune profile at full width, fp32, from model_dtu.npz; 3
   epochs of 2 steps, launch counts reset just before and read just
   after, each step timed by CUDA events: samples/s and peak memory),
   holds one step at that config with the kernels against one with the
   plain versions, and runs ``--mode test`` (K4 in its eval forwards) and
   ``--mode profile`` (a ``torch.profiler`` trace);
8. spawns two ranks on the one card (gloo on CUDA tensors: NCCL refuses
   two ranks on one device) and holds a data-parallel fine-tune step
   (4 + 4), a view-sharded one (3 + 3 sources) and the view-sharded engine
   on a DTU request, then the depth-sharded step (48 + 48 stage-1
   hypotheses) and the JAX CLI's default ``views,depth``, against this
   process's single-process results (``parallel/equivalence.py``, the JAX
   gate's bounds), with each rank's peak memory, after K1 on each D-block
   of the expanded stage-1 sweep against its plain version; then
   (``distributed_spatial``) the row-sharded step (``spatial``: 288 + 288
   image rows, stage 1 36 + 36) and ``views,spatial`` at the fine-tune
   config with each rank's peak memory and K1/K2/K3 launches, and the
   row-sharded engine on the DTU request (864 rows: 416 + 448, K4 on the
   row blocks) against the single process's maps, after K1 and K3 on the
   two row blocks of the fine-tune stage-1 and stage-3 shapes (each
   against its plain version with the same row offset, K1 also against
   the whole image's rows); then (``distributed_depth_spatial``, one
   spawn) ``depth,spatial`` (the 2-D activations 288 + 288 rows, the
   volumes 48 + 48 stage-1 and 4 + 4 later hypotheses over all rows) and
   ``views,depth,spatial`` at the fine-tune config, each against the same
   single-process step at the gate's bounds, with K1 3, K2 9, K3 3 a
   rank's step, each rank's peak memory beside ``depth``'s and
   ``spatial``'s and a rank's ``memory_phases``; NCCL across cards is not
   exercised;
9. (``device_cache``) writes a DTU-training tree at the training config
   from the seed (12 views, 7 lights, 640x512: about 0.1 GB in the
   cache), builds ``data/device_cache.py``'s cache on the card and holds
   its test-mode batches to the ``Loader``'s after ``batch_to_device``
   (every leaf but the images bit for bit; the images in their bytes and
   within one fp32 ulp: the cache rounds x / 255 as the JAX cache does,
   x times the reciprocal) and shows ``batch_to_device`` passing them
   through without a copy; then runs ``cli/train.py main --mode train``
   for an epoch (21 steps, 3 eval batches) fed by the cache and by the
   ``Loader`` in turns, with each run's launch counts (K1 3, K2 9, K3 3 a
   step; K4 in the eval forwards) and its samples/s by CUDA events and
   by the host clock from one step's end to the next's, and the cache's
   bytes;
10. (``jax_checkpoint``) carries a JAX training run onto the card with no
   JAX, optax or orbax here: ``tests/jax_pickle.py`` writes the JAX train
   CLI's pickle (the shipped DTU weights in the JAX layouts, the AdamW
   moments of 21 seeded updates, the optax classes named as in a real
   file) into a logdir on the same tree; ``cli/train.py main --resume``
   continues it at epoch 1 for 21 steps at the DTU training config (K1 3,
   K2 9, K3 3 a step; K4 in the eval forwards), with the moments, AdamW
   steps and learning rate read at the first resumed step and that step's
   loss and gradients held against the plain path; then the carried
   weights serve through ``InferenceEngine(device="cuda")`` at the DTU
   eval config (K1, K2, K4), the 13 maps and the confidence bitwise the
   npz-loaded engine's;
11. runs the compile-check entry (``entry.py``): ``entry()``'s forward on
   the card against the CPU, and ``dryrun_multichip(2)``;
12. prints each phase's seconds, a ``{"kernels": [...]}`` line (K2, K4
   and conv3d_reg entries name the CUDA route of each layer in
   ``cuda_route``: ``mma`` on the tensor cores, ``fma`` on the CUDA
   cores; K1-K4 and conv3d_reg carry their launches in the cache-fed
   run, in the resumed JAX run and its served forward, and K1-K3 in a
   ``depth,spatial`` rank's step), the card's name and power limit, then
   the device line last.

Any failure raises and the exit code is nonzero.  Without a GPU it exits
1 and prints no result.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM rates (NVIDIA data sheet, dense): device memory, fp32
# outside the tensor cores, bf16 on the tensor cores
MEM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# |kernel - plain| <= ATOL[kernel] * scale + RTOL[dtype] * |plain|,
# elementwise (see check_kernel; K4: check_chain)
ATOL = {"warp_correlate": 1e-3, "conv_gru": 1e-4, "warp_correlate_bwd": 1e-3,
        "conv_chain": 5e-5}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
SEED = 0

CONFIGS = {
    # B, views, H, W, ndepths, (quarter-res focal), depth_min, interval
    "dtu": dict(B=6, V=5, H=864, W=1152, ndepths=(48, 8, 8), f=360.0,
                dmin=425.0, dint=2.5 * 0.53, step=(15.0, 4.0, 2.0),
                ang=0.02),
    "tnt": dict(B=1, V=11, H=1056, W=1920, ndepths=(96, 8, 8), f=556.75,
                dmin=0.5, dint=7.5 / 384, step=(0.25, 0.05, 0.02),
                ang=0.03),
}
# the DTU training config (cli/train.py's dtu_train profile at the
# reference's 640x512 crops, B=4): the training path and K3's phases
TRAIN = dict(B=4, V=5, H=512, W=640, ndepths=(48, 8, 8), f=361.54,
             dmin=425.0, dint=2.5 * 0.53, step=(15.0, 4.0, 2.0), ang=0.02)
TRAIN_STEPS = (2, 5)          # warm-up and timed training steps
# the device cache's DTU tree: a dozen views under 7 lights at the training
# config (about 0.1 GB on the card), raw depth with a margin of 64 pixels
CACHE_TREE = dict(views=12, lights=7, scan="scan1", margin=64)
# the BlendedMVS fine-tuning config (cli/train.py --mode finetune, the
# blend_finetune profile: 768x576, 7 views, 96/8/8, B=8, fp32) for K1-K3's
# phases; the seeded rig of the rendered tree below (quarter-res focal)
BLEND = dict(B=8, V=7, H=576, W=768, ndepths=(96, 8, 8), f=1.16 * 768 / 4,
             dmin=0.4, dint=3.1 / 384, step=(0.04, 0.01, 0.0), ang=0.02)
# the rendered BlendedMVS tree: a textured plane seen by 17 cameras on a
# line (every ref keeps 16 >= 7 sources), 3 fine-tune epochs of 2 steps
BLEND_TREE = dict(views=17, plane_z=1.6, band=(0.4, 3.5), focal_mult=1.16,
                  baseline=0.04, epochs=3, scan="synthetic_plane")
ND = 384                      # inverse-depth samples per batch item
HDIM = (48, 32, 16)
CDIM = (32, 16, 8)            # feature channels per stage
RATIO = (4.0, 2.0, 1.0)       # depth_intervals_ratio
# the T&T reconstruction rig (E2E_TANK_r05.json's point): plane, band,
# focal multiple, baseline and ground-truth spacing, in metres / mm
TANK = dict(H=1056, W=1920, V=11, plane_z=1.6, band=(0.4, 3.5),
            focal_mult=1.16, baseline=0.04, gt_spacing_mm=4.0)
TANK_SPACING_MM = (TANK["plane_z"] ** 2 * (1 / TANK["band"][0]
                                           - 1 / TANK["band"][1])
                   / 95 * 1000.0)   # stage-1 hypothesis spacing at the plane


def log(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rig(cfg, camio):
    """The seeded camera rig of a config: per-stage (B,V,2,4,4) stacks
    (stage1..stage4) and (B, ND) ascending inverse depths."""
    B, V, H, W = cfg["B"], cfg["V"], cfg["H"], cfg["W"]
    intr_q = np.array([[cfg["f"], 0, W / 8], [0, cfg["f"], H / 8],
                       [0, 0, 1]], np.float32)
    exts = [np.eye(4, dtype=np.float32)]
    for v in range(1, V):
        E = np.eye(4, dtype=np.float32)
        a = cfg["ang"] * v
        c, s = np.cos(a), np.sin(a)
        E[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        E[:3, 3] = [st * v for st in cfg["step"]]
        exts.append(E)
    projs = [camio.stage_proj_matrices(E, intr_q) for E in exts]
    proj_ms = {k: np.broadcast_to(np.stack([p[k] for p in projs])[None],
                                  (B, V, 2, 4, 4)).copy()
               for k in ("stage1", "stage2", "stage3", "stage4")}
    dv = np.broadcast_to(camio.inverse_depth_values(
        cfg["dmin"], cfg["dint"], ND)[None], (B, ND)).copy()
    return proj_ms, dv


def median_ms(torch, fn, reps):
    """Median device time of fn() over reps runs (CUDA events), after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unique_bytes(t):
    """Bytes of the distinct elements a tensor holds (an expanded view
    counts once per stored element)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def bound(bytes_, flops, dtype):
    t_bytes = bytes_ / MEM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def stage_inputs(torch, geometry, cfg, proj_ms, dv, s, dtype, gen):
    """K1 inputs at stage s (0-based) of a config, built as the model
    builds them: features (seeded), relative projections, and the stage's
    depth hypotheses (stage 1: the expanded global sweep; later stages:
    a per-pixel sweep around a smooth depth surface)."""
    B, V = cfg["B"], cfg["V"]
    h, w = cfg["H"] // 2 ** (3 - s), cfg["W"] // 2 ** (3 - s)
    C, D = CDIM[s], cfg["ndepths"][s]
    dev = "cuda"
    feats = torch.randn((B, V, h, w, C), generator=gen, device=dev)
    feats = feats.to(dtype)
    P = geometry.compose_projection(
        torch.from_numpy(proj_ms[f"stage{s + 1}"]).to(dev))
    rots, trs = geometry.relative_projection(P[:, 1:],
                                             P[:, :1].expand_as(P[:, 1:]))
    dvt = torch.from_numpy(dv).to(dev)
    if s == 0:
        drs = geometry.depth_range_samples_global(dvt, D, 1, 1)
        depth = (1.0 / drs).expand(B, D, h, w)
    else:
        lo, hi = 1.0 / float(dv[0, -1]), 1.0 / float(dv[0, 0])
        yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        surf = 0.5 + 0.3 * torch.sin(xx / (w / 7.0)) * torch.cos(yy / (h / 5.0))
        cur = (lo + (hi - lo) * surf)[None].expand(B, h, w)
        interval = (dvt[:, -1] - dvt[:, 0]) / ND * RATIO[s]
        depth = 1.0 / geometry.depth_range_samples_local(
            1.0 / cur, D, interval[:, None, None])
    return feats[:, 0], feats[:, 1:], rots, trs, depth


def check_kernel(kernel, what, got, want, dtype, scale=1.0):
    """Hold a kernel's output against its plain version's, elementwise:
    |kernel - plain| <= atol * scale + rtol * |plain|.

    atol: the two compute the same fp32 function in another order.  K2
    (1e-4, the CPU tests' tolerance against JAX) sums 9*2*hd products of
    unit-scale values.  K1 (1e-3) also projects every pixel: at 576-1920
    px wide maps a coordinate carries a few 1e-5 px of rounding that
    differs between the plain version's einsum and the kernel's FMAs, and
    the bilinear slope of unit-variance features turns that into up to a
    few 1e-4 of correlation.  K3 (1e-3 of max(1, max |plain|), the
    gradient's scale) sums (g/C) * w * feature over the views and
    hypotheses (d_ref) or over every pixel and hypothesis that lands on a
    source texel (d_src, with fp32 atomics in no fixed order), with tap
    weights that carry K1's coordinate rounding; the CPU tests hold the
    plain backward to 1e-4 of that scale against JAX at their small
    shapes.
    rtol: 0 in fp32; 2^-8 in bf16, where the plain version runs in fp32 on
    the same bf16-valued inputs (and bf16-rounded weights) and the kernel,
    which accumulates in fp32, rounds its output to bf16 once (relative
    error at most 2^-9).  Returns the max absolute error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    atol = ATOL[kernel] * scale
    excess = float((diff - atol - RTOL[dtype] * want.abs()).max())
    if not excess <= 0:
        raise AssertionError(
            f"{kernel} {what}: kernel differs from plain beyond "
            f"{atol:.3g} + {RTOL[dtype]} |plain| (by {excess:.3e}, "
            f"max abs {float(diff.max()):.3e})")
    return float(diff.max())


def bounds_in_slices(fn, batched, rest, out_numel):
    """``rounding_bounds``' fn(*batched, *rest) a slice of the batch axis
    at a time (about 2^26 outputs each, to bound the float64 temporaries);
    (lo, hi, values with two roundings)."""
    import torch
    B = batched[0].shape[0]
    step = max(1, 2 ** 26 * B // out_numel)
    parts = [fn(*(t[i:i + step] for t in batched), *rest)
             for i in range(0, B, step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]), sum(p[2] for p in parts))


def check_within(what, got, want, lo, hi, tol):
    """A bf16 kernel's output within ``tol`` of [lo, hi], elementwise.
    Returns the outputs past ``tol`` of ``want``, the plain version,
    which only the range admits."""
    g = got.double()
    dist = (lo - g).clamp(min=0) + (g - hi).clamp(min=0)
    excess = float((dist - tol).max())
    if not excess <= 0:
        raise AssertionError(
            f"{what}: kernel outside the tolerance of the range its "
            f"rounding points give (by {excess:.3e}; max abs against plain "
            f"{float((got.float() - want).abs().max()):.3e})")
    return int(((got.float() - want).abs() > tol).sum())


def check_gru(what, got, want, dtype, args):
    """K2 against ``_gru_reference`` before its last rounding (``want``),
    at check_kernel's tolerance.  In bf16 the kernel and the reference
    each round r*h to bf16 (the TPU kernel's rounding point) after their
    own fp32 sum, so an r*h within fp32 noise of a rounding boundary may
    round either way, and the outputs it reaches move with it.  So in bf16
    the kernel must lie within that tolerance of [lo, hi], the range of h'
    over both roundings of every such r*h (``rounding_bounds.gru_bounds``
    on ``args``, float64; lo = hi at an output that reads none).  Returns
    (max abs error against want, outputs past the tolerance of want, r*h
    values with two roundings)."""
    if dtype == "float32":
        return check_kernel("conv_gru", what, got, want, dtype), 0, 0
    from effi_mvs_plus_tpu_torch.ops import rounding_bounds
    lo, hi, two = bounds_in_slices(rounding_bounds.gru_bounds, args[:2],
                                   args[2:], got.numel())
    beyond = check_within(f"conv_gru {what}", got, want, lo, hi,
                          ATOL["conv_gru"] + RTOL[dtype] * want.abs())
    return float((got.float() - want).abs().max()), beyond, two


def check_depth_maps(what, out_k, out_p, floor):
    """The 13 depth maps of a forward with the kernels against one with the
    plain versions, at the golden tolerance (tests/test_model_golden.py):
    max error under 0.5% of the map's range plus `floor` (0.5 mm in the
    depth's unit).  Returns (worst max error, worst error / tolerance)."""
    worst = ratio = 0.0
    for i, (g, want) in enumerate(zip(out_k["depth"], out_p["depth"])):
        tol = 0.005 * float(want.max() - want.min()) + floor
        err = float((g - want).abs().max())
        worst, ratio = max(worst, err), max(ratio, err / tol)
        if not err < tol:
            raise AssertionError(f"{what} depth {i}: kernels vs plain "
                                 f"{err:.3e} (tolerance {tol:.3e})")
    return worst, ratio


@contextlib.contextmanager
def plain_kernels(cuda_warp, cuda_gru, cuda_conv):
    """Route the model's kernel calls to their plain versions (for the
    full-forward comparisons only), the fused 3-D layers'
    (``ops/cuda_conv3d.py``) too."""
    from effi_mvs_plus_tpu_torch.ops import cuda_conv3d
    saved = (cuda_warp.warp_correlate_views, cuda_gru.gru_step,
             cuda_conv.conv_bn_relu_chain, cuda_conv3d.conv3d_reg)

    def warp_plain(ref, src, rots, trs, depth, y0=0):
        return cuda_warp._views_torch(ref, src, rots, trs, depth,
                                      y0).to(ref.dtype)

    def gru_plain(h, x, p, packed=None):
        return cuda_gru._gru_torch(h, x, p.convz.weight, p.convr.weight,
                                   p.convq.weight, p.convz.bias,
                                   p.convr.bias, p.convq.bias)

    def chain_plain(x, specs, packed=None):
        return cuda_conv._chain_torch(x, specs)

    def reg_plain(x, layer, x2=None, res=None):
        return cuda_conv3d._reg_torch(x, layer, x2, res)
    (cuda_warp.warp_correlate_views, cuda_gru.gru_step,
     cuda_conv.conv_bn_relu_chain, cuda_conv3d.conv3d_reg) = (
        warp_plain, gru_plain, chain_plain, reg_plain)
    try:
        yield
    finally:
        (cuda_warp.warp_correlate_views, cuda_gru.gru_step,
         cuda_conv.conv_bn_relu_chain, cuda_conv3d.conv3d_reg) = saved


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run",
              file=sys.stderr)
        return 1
    return run(torch, nvidia_smi())


def run(torch, card):
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.ops import _kernels

    root = os.path.dirname(os.path.abspath(__file__))
    t_run = t_lap = time.perf_counter()
    seconds = {}

    def lap():
        nonlocal t_lap
        t, t_lap = t_lap, time.perf_counter()
        return t_lap - t
    resolve_device("cuda")          # true fp32: TF32 off for cuDNN, matmul
    log({"phase": "device", "nvidia_smi": card,
         "name": torch.cuda.get_device_name(0),
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 1. build ----
    t0 = time.perf_counter()
    _kernels.library()
    build_s = _kernels.build_seconds()
    log({"phase": "build", "nvcc_seconds": round(build_s, 2),
         "total_seconds": round(time.perf_counter() - t0, 2)})
    seconds["build"] = lap()

    sd = load_npz_checkpoint(os.path.join(root, "checkpoints",
                                          "model_dtu.npz"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    # ---- 2. kernel phases ----
    with torch.inference_mode():
        entries = forward_kernel_phases(torch, sd, gen)
    seconds["k1_k2_phases"] = lap()
    entries += bwd_kernel_phases(torch, gen)
    seconds["k3_phases"] = lap()
    with torch.inference_mode():
        chain_entries = conv_chain_phases(torch, root, gen)
    torch.cuda.empty_cache()
    seconds["k4_phases"] = lap()
    with torch.inference_mode():
        reg_entries = conv3d_reg_phases(torch, root, gen)
    torch.cuda.empty_cache()
    seconds["conv3d_reg_phases"] = lap()

    # ---- 3. serving path, and the DTU forward with and without K4 ----
    with torch.inference_mode():
        k1_main, k2_main, k4_main, reg_main = serving_path(torch, sd)
    seconds["serving_path"] = lap()
    stem_ab(torch, sd)
    torch.cuda.empty_cache()
    seconds["dtu_fused_stem"] = lap()

    # ---- 4. training path ----
    train = training_path(torch, sd)
    torch.cuda.empty_cache()
    seconds["training_path"] = lap()

    # ---- 5. T&T reconstruction path ----
    tank = tank_path(torch, root)
    seconds["tank_path"] = lap()

    # ---- 6. BlendedMVS fine-tuning, then two ranks on the card ----
    from effi_mvs_plus_tpu_torch.data import cams as camio
    with tempfile.TemporaryDirectory() as tree:
        listfile = render_blend_tree(torch, tree, camio)
        seconds["blend_render"] = lap()
        finetune, test = finetune_path(torch, root, tree, listfile)
        seconds["finetune_path"] = lap()
        rows_entries, dsp_launches = distributed_phase(torch, tree,
                                                       listfile, sd)
        seconds["distributed"] = lap()
    with tempfile.TemporaryDirectory() as dtu_tree:
        t0 = time.perf_counter()
        dtu_list = write_dtu_tree(dtu_tree)
        cache = device_cache_phase(torch, dtu_tree, dtu_list,
                                   time.perf_counter() - t0)
        seconds["device_cache"] = lap()
        jax_resume, jax_serve = jax_checkpoint_phase(torch, root, dtu_tree,
                                                     dtu_list, sd)
        seconds["jax_checkpoint"] = lap()
    entry_phase(torch)
    seconds["entry"] = lap()

    for e in entries:
        name = {"warp_correlate": "k1_launches", "conv_gru": "k2_launches",
                "warp_correlate_bwd": "k3_launches"}[e["name"]]
        e["launches_finetune"] = finetune[name]
        if e["config"] == "blend":
            e["launches"] = finetune[name]
        elif e["name"] == "warp_correlate_bwd":
            e["launches"] = train["k3_launches"]
        else:
            e["launches"] = k1_main if name == "k1_launches" else k2_main
        if e["name"] != "warp_correlate_bwd":
            e["launches_train"] = train[name]
            e["launches_tnt"] = tank[name]
        e["launches_device_cache"] = cache[name]
        e["launches_jax_checkpoint_resume"] = jax_resume[name]
        if name != "k3_launches":
            e["launches_jax_checkpoint_serve"] = jax_serve[name]
        e["launches_depth_spatial_rank"] = dsp_launches["depth_spatial"][
            name[:2]]
    for e in chain_entries:
        e["launches"] = k4_main
        e["launches_tnt"] = tank["k4_launches"]
        e["launches_finetune_test"] = test["k4_launches"]
        e["launches_device_cache"] = cache["k4_launches"]
        e["launches_jax_checkpoint_resume"] = jax_resume["k4_launches"]
        e["launches_jax_checkpoint_serve"] = jax_serve["k4_launches"]
    for e in reg_entries:
        e["launches"] = reg_main
        e["launches_tnt"] = tank["conv3d_reg_launches"]
        e["launches_train"] = train["conv3d_reg_launches"]
        e["launches_finetune_test"] = test["conv3d_reg_launches"]
        e["launches_device_cache"] = cache["conv3d_reg_launches"]
        e["launches_jax_checkpoint_resume"] = jax_resume[
            "conv3d_reg_launches"]
        e["launches_jax_checkpoint_serve"] = jax_serve["conv3d_reg_launches"]
    log({"phase": "seconds", **seconds,
         "total": time.perf_counter() - t_run})
    print(json.dumps({"kernels": entries + chain_entries + reg_entries
                      + rows_entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def forward_kernel_phases(torch, sd, gen):
    """K1 and K2 against their plain versions at the DTU eval, T&T and
    DTU training stage shapes, and K1 on the off-image and
    behind-the-camera rigs."""
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.ops import cuda_warp

    entries = []
    for cname, cfg in (*CONFIGS.items(), ("train", TRAIN), ("blend", BLEND)):
        proj_ms, dv = rig(cfg, camio)
        for s in range(3):
            for dname, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16)):
                entries.append(warp_entry(torch, gen, cname, cfg, proj_ms,
                                          dv, s, dname, dtype))
                B, h, w = (cfg["B"], cfg["H"] // 2 ** (3 - s),
                           cfg["W"] // 2 ** (3 - s))
                entries.append(gru_entry(torch, sd, gen, cname, (B, h, w),
                                         s, dname, dtype))
                log({"phase": "kernels", **entries[-2]})
                log({"phase": "kernels", **entries[-1]})
        torch.cuda.empty_cache()

    # K1 on rigs that leave the image and that see hypotheses from behind,
    # at stage 1 (the expanded sweep through the windowed kernel) and stage
    # 2 (per-pixel depths through the direct kernel)
    cfg = CONFIGS["dtu"]
    proj_ms, dv = rig(cfg, camio)
    for s in (0, 1):
        ref, src, rots, trs, depth = stage_inputs(
            torch, geometry, cfg, proj_ms, dv, s, torch.float32, gen)
        h, w = ref.shape[1], ref.shape[2]
        # off_image: trans is in pixels x depth, so this shifts the
        # projections by 40% / 20% of the map at a mid-range depth.
        # behind: the negated camera sees every hypothesis at z < 0 and
        # projects each ref pixel to the same place (grid_sample semantics
        # cull nothing behind a camera), so it must reproduce the ordinary
        # rig's correlations exactly.
        wild = {"off_image": (rots, trs + torch.tensor(
                    [0.4 * w * 680.0, 0.2 * h * 680.0, 0.0], device="cuda")),
                "behind": (-rots, -trs)}
        ordinary = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
        for rname, (r_, t_) in wild.items():
            got = cuda_warp.warp_correlate_views(ref, src, r_, t_, depth)
            err = check_kernel("warp_correlate", f"{rname} stage{s + 1}", got,
                               cuda_warp._views_torch(ref, src, r_, t_, depth),
                               "float32")
            zero = float((got == 0).float().mean())
            if rname == "off_image" and not 0.05 < zero < 0.95:
                raise AssertionError(
                    f"K1 off_image stage{s + 1}: zero share {zero}")
            if rname == "behind" and not torch.equal(got, ordinary):
                raise AssertionError(
                    f"K1 behind stage{s + 1}: differs from the ordinary rig")
            log({"phase": "kernel_rig", "rig": rname, "stage": s + 1,
                 "max_abs_err": err, "zero_share": zero})
        del ref, src, depth, ordinary, got
        torch.cuda.empty_cache()
    return entries


def window_share(stats):
    """The share of taps (K3: adds) served from shared-memory windows, of
    a kernel's counters (from the windows, from device memory)."""
    window, device = int(stats[0]), int(stats[1])
    return window / max(1, window + device)


def warp_entry(torch, gen, cname, cfg, proj_ms, dv, s, dname, dtype):
    """K1 at stage s (0-based) of a config: held against its plain version
    (``check_kernel``) and timed; with the share of its taps read from the
    shared-memory windows.  Returns its entry."""
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.ops import cuda_warp
    ref, src, rots, trs, depth = stage_inputs(
        torch, geometry, cfg, proj_ms, dv, s, dtype, gen)
    B, V, D = src.shape[0], src.shape[1], depth.shape[1]
    h, w, C = ref.shape[1], ref.shape[2], ref.shape[3]

    def k1():
        return cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)

    def p1():
        return cuda_warp._views_torch(ref.float(), src.float(), rots, trs,
                                      depth)
    err = check_kernel("warp_correlate", f"{cname} stage{s + 1} {dname}",
                       k1(), p1(), dname)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    cuda_warp._views_cuda(ref, src, rots, trs, depth, stats)
    esz = ref.element_size()
    n_out = B * V * D * h * w
    tapped = tapped_texels(torch, geometry, rots, trs, depth, h, w)
    byts = (ref.numel() + tapped * C + n_out) * esz \
        + unique_bytes(depth) + (rots.numel() + trs.numel()) * 4
    bms, bby = bound(byts, n_out * (10 * C + 16), dname)
    return dict(
        name="warp_correlate", route="cuda",
        source="effi_mvs_plus_tpu_torch/csrc/warp_correlate.cu",
        replaces="effi_mvs_plus_tpu/ops/pallas_warp.py:427",
        config=cname, stage=s + 1, dtype=dname,
        shape=f"B{B} V{V} D{D} {h}x{w} C{C}",
        launches_per_forward=3, max_abs_err=err,
        window_share=window_share(stats), texel_reads=int(stats.sum()),
        src_texels_tapped=tapped / (B * V * h * w),
        ms=median_ms(torch, k1, 21),
        plain_ms=median_ms(torch, p1, 3),
        bound_ms=bms, bound_by=bby, library_ms=None)


def gru_entry(torch, sd, gen, cname, bhw, s, dname, dtype):
    """K2 at stage s (0-based) of a config, maps (B, h, w): the checkpoint's
    GRU on seeded h = tanh, x = relu of N(0, 1), held against
    ``_gru_reference`` (``check_gru``) and timed on weights packed once
    (``ms``) and packed at each call (``pack_ms``); returns its entry."""
    from effi_mvs_plus_tpu_torch.ops import cuda_gru
    B, h, w = bhw
    hd = HDIM[s]
    gru = gru_module(sd, s + 1, hd)
    hx = torch.randn((2, B, h, w, hd), generator=gen, device="cuda")
    hh = torch.tanh(hx[0]).to(dtype).contiguous()
    xx = torch.relu(hx[1]).to(dtype).contiguous()
    del hx
    wk = [getattr(gru, g).weight for g in ("convz", "convr", "convq")]
    bk = [getattr(gru, g).bias for g in ("convz", "convr", "convq")]
    packed = cuda_gru.pack(gru, dtype)

    def k2(packed=packed):
        return cuda_gru.gru_step(hh, xx, gru, packed)

    def p2():
        # the TPU kernel's rounding points (r*h in the inputs' dtype), h'
        # before its one rounding
        return cuda_gru._gru_reference(hh, xx, *wk, *bk, rounded=False)
    err, beyond, two = check_gru(f"{cname} stage{s + 1} {dname}", k2(),
                                 p2(), dname, (hh, xx, *wk, *bk))
    npx = B * h * w
    esz = hh.element_size()
    byts = 3 * npx * hd * esz + (9 * 2 * hd * 3 * hd + 3 * hd) * 4
    bms, bby = bound(byts, 108 * hd * hd * npx, dname)
    return dict(
        name="conv_gru", route="cuda",
        cuda_route="mma" if dtype == torch.bfloat16 else "fma",
        source="effi_mvs_plus_tpu_torch/csrc/conv_gru.cu",
        replaces="effi_mvs_plus_tpu/ops/pallas_gru.py:104",
        config=cname, stage=s + 1, dtype=dname,
        shape=f"B{B} {h}x{w} hd{hd}",
        launches_per_forward=9, max_abs_err=err,
        beyond_plain_tolerance=beyond, two_roundings=two,
        ms=median_ms(torch, k2, 7),
        pack_ms=median_ms(torch, lambda: k2(None), 7),
        plain_ms=median_ms(torch, p2, 3),
        bound_ms=bms, bound_by=bby, library_ms=None)


def dtu_batch(camio):
    """One DTU eval request (B=6, 5 views, 1152x864): seeded noise images
    on the seeded rig, in the loader's layout."""
    cfg = CONFIGS["dtu"]
    B = cfg["B"]
    proj_ms, dv = rig(cfg, camio)
    rng = np.random.default_rng(SEED)
    imgs = rng.uniform(0, 1, (B, cfg["V"], cfg["H"], cfg["W"], 3)).astype(
        np.float32)
    return {"imgs": imgs, "proj_matrices": proj_ms, "depth_values": dv,
            "filename": [f"scan1/{{}}/{b:08d}{{}}" for b in range(B)]}


def timed_request(torch, eng, batch):
    """(device ms, depth, conf) of one engine request, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    depth, conf = eng._infer_device(batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), depth, conf


def serving_path(torch, sd):
    """The engine at the DTU eval config, fp32 and bf16; returns the K1,
    K2, K4 and conv3d_reg launch counts of the run."""
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.pfm import read_pfm
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    from effi_mvs_plus_tpu_torch.ops import cuda_conv, cuda_gru, cuda_warp

    cfg = CONFIGS["dtu"]
    B = cfg["B"]
    batch = dtu_batch(camio)
    imgs, proj_ms, dv = (batch[k] for k in ("imgs", "proj_matrices",
                                            "depth_values"))
    eng32 = InferenceEngine(sd, EffiMVSConfig(), device="cuda")
    eng16 = InferenceEngine(sd, EffiMVSConfig(compute_dtype=torch.bfloat16),
                            device="cuda")

    def counts():
        n = launch_counts()
        return (n["k1_launches"], n["k2_launches"], n["k4_launches"],
                n["conv3d_reg_launches"])

    reset_launches()
    forwards = 0
    t32 = []
    for i in range(4):
        ms, d32, c32 = timed_request(torch, eng32, batch)
        forwards += 1
        if counts() != (3 * forwards, 9 * forwards, 8 * forwards,
                        25 * forwards):
            raise AssertionError(
                f"after {forwards} forwards: K1, K2, K4, conv3d_reg "
                f"launched {counts()} times (want 3, 9, 8 and 25 each)")
        if i:
            t32.append(ms)
    t16 = []
    for i in range(3):
        ms, d16, c16 = timed_request(torch, eng16, batch)
        forwards += 1
        if i:
            t16.append(ms)
    with tempfile.TemporaryDirectory() as out:
        stats = eng32.save_scene_depths([batch], out, verbose=False)
        forwards += 1
        for b in range(B):
            for kind, shape in (("depth_est", (cfg["H"], cfg["W"])),
                                ("confidence", (cfg["H"] // 2,
                                                cfg["W"] // 2))):
                arr, _ = read_pfm(os.path.join(out, "scan1", kind,
                                               f"{b:08d}.pfm"))
                if arr.shape != shape or not np.isfinite(arr).all():
                    raise AssertionError(f"{kind} {b}: {arr.shape}")
            camio.read_cam_file(os.path.join(out, "scan1", "cams",
                                             f"{b:08d}_cam.txt"))
    k1_main, k2_main, k4_main, reg_main = counts()
    if (k1_main, k2_main, k4_main, reg_main) != (
            3 * forwards, 9 * forwards, 8 * forwards, 25 * forwards) \
            or not k1_main:
        raise AssertionError(f"main path: {forwards} forwards, K1, K2, K4, "
                             f"conv3d_reg launched {counts()} times")

    d32, c32 = d32.cpu().numpy(), c32.cpu().numpy()
    d16, c16 = d16.cpu().numpy(), c16.cpu().numpy()
    lo, hi = 1.0 / float(dv[0, -1]), 1.0 / float(dv[0, 0])
    for name, d, c in (("fp32", d32, c32), ("bf16", d16, c16)):
        if d.shape != (B, cfg["H"], cfg["W"]) or \
                c.shape != (B, cfg["H"] // 2, cfg["W"] // 2):
            raise AssertionError(f"{name}: shapes {d.shape} {c.shape}")
        if not (np.isfinite(d).all() and np.isfinite(c).all()):
            raise AssertionError(f"{name}: non-finite output")
        if not (d.min() > 0 and d.max() <= 1e4 and c.min() >= 0
                and c.max() <= 1 + 1e-3):
            raise AssertionError(f"{name}: depth [{d.min()}, {d.max()}] or "
                                 f"confidence [{c.min()}, {c.max()}] out of "
                                 f"range")

    # fp32 parity of all 13 maps with the plain versions on the card
    model = eng32.model
    args = (torch.from_numpy(imgs).cuda(),
            {k: torch.from_numpy(proj_ms[k]).cuda()
             for k in ("stage1", "stage2", "stage3")},
            torch.from_numpy(dv).cuda())
    with torch.inference_mode():
        out_k = model(*args)
        n = counts()
        with plain_kernels(cuda_warp, cuda_gru, cuda_conv):
            out_p = model(*args)
        if counts() != n:
            raise AssertionError("the plain forward launched a kernel")
    worst, _ = check_depth_maps("DTU", out_k, out_p, 0.5)
    # the confidence reads a 4-bin window at int(expected index): a pixel
    # whose expectation sits within rounding of an integer may take the
    # neighbouring window in one of the two runs, so a handful of the
    # 6 x 432 x 576 pixels may jump; everywhere else the golden 5e-3 holds
    conf_diff = (out_k["photometric_confidence"]
                 - out_p["photometric_confidence"]).abs()
    conf_err = float(conf_diff.max())
    conf_jump = float((conf_diff >= 5e-3).float().mean())
    if not conf_jump < 1e-3:
        raise AssertionError(f"confidence: {conf_jump:.2e} of pixels differ "
                             f"by >= 5e-3 (max {conf_err:.2e})")

    ms32, ms16 = statistics.median(t32), statistics.median(t16)
    log({"phase": "serving_path", "config": "dtu B6 V5 1152x864 48/8/8",
         "weights": "checkpoints/model_dtu.npz", "forwards": forwards,
         "k1_launches": k1_main, "k2_launches": k2_main,
         "k4_launches": k4_main, "conv3d_reg_launches": reg_main,
         "fp32_request_ms": t32, "bf16_request_ms": t16,
         "fp32_maps_per_s": B / (ms32 / 1e3),
         "bf16_maps_per_s": B / (ms16 / 1e3),
         "save_scene_depths": stats,
         "fp32_vs_plain_worst_depth_abs": worst,
         "fp32_vs_plain_conf_abs": conf_err,
         "fp32_vs_plain_conf_share_over_5e-3": conf_jump,
         "bf16_vs_fp32_median_depth_abs": float(np.median(np.abs(d16 - d32))),
         "depth_range_mm": [lo, hi],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return k1_main, k2_main, k4_main, reg_main


def plain_bwd(torch, cuda_warp, ref, src, rots, trs, depth, y0=0):
    """The plain backward: autograd of the plain warp, in fp32 on the same
    values (ref rows from ``y0``).  Returns grad(g) -> (d_ref, d_src),
    graph kept for reruns."""
    r = ref.float().requires_grad_()
    s = src.float().requires_grad_()
    out = cuda_warp._views_torch(r, s, rots, trs, depth, y0)
    return lambda g: torch.autograd.grad(out, (r, s), g.float(),
                                         retain_graph=True)


def valid_taps(torch, geometry, rots, trs, depth, h, w, row0=0):
    """In-image bilinear taps of the warp over all views and hypotheses
    (depth's ref rows from ``row0``, source maps of h rows): K3 reads,
    accumulates and scatters C channels for each."""
    n = 0
    for v in range(rots.shape[1]):
        px, py = geometry.project_to_src(rots[:, v], trs[:, v], depth,
                                         depth.shape[2], w, row0)
        x0, y0 = torch.floor(px), torch.floor(py)
        inx = [(x0 + o >= 0) & (x0 + o < w) for o in (0, 1)]
        iny = [(y0 + o >= 0) & (y0 + o < h) for o in (0, 1)]
        n += sum(int((a & b).sum()) for a in inx for b in iny)
    return n


def tapped_texels(torch, geometry, rots, trs, depth, h, w, row0=0):
    """Distinct source texels, counted per batch and view, that the
    warp's in-image bilinear taps reach (depth's ref rows from ``row0``,
    source maps of h rows): what a kernel must read of the sources."""
    B, n = depth.shape[0], 0
    b = torch.arange(B, device=depth.device).view(B, 1, 1, 1)
    for v in range(rots.shape[1]):
        px, py = geometry.project_to_src(rots[:, v], trs[:, v], depth,
                                         depth.shape[2], w, row0)
        x0, y0 = torch.floor(px), torch.floor(py)
        hit = torch.zeros(B * h * w, dtype=torch.bool, device=depth.device)
        for oy in (0, 1):
            for ox in (0, 1):
                x, y = x0 + ox, y0 + oy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                flat = (b * h + y.clamp(0, h - 1).long()) * w + x.clamp(
                    0, w - 1).long()
                hit[flat[ok]] = True
        n += int(hit.sum())
    return n


def bwd_kernel_phases(torch, gen):
    """K3 against the plain backward at the DTU training and eval stage
    shapes, fp32 and bf16, with the run-to-run difference of two launches
    (d_src's fp32 atomics add in no fixed order); then on the off-image
    and behind-the-camera rigs."""
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.ops import cuda_warp

    def check(what, ref, src, rots, trs, depth, g, dname, stats=None):
        got = cuda_warp._views_bwd_cuda(ref, src, rots, trs, depth, g, stats)
        again = cuda_warp._views_bwd_cuda(ref, src, rots, trs, depth, g)
        want = plain_bwd(torch, cuda_warp, ref, src, rots, trs, depth)(g)
        scale = max(1.0, *(float(t.abs().max()) for t in want))
        err = max(check_kernel("warp_correlate_bwd", f"{what} {n}", a, b,
                               dname, scale)
                  for n, a, b in zip(("d_ref", "d_src"), got, want))
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"K3 {what}: d_ref differs between runs")
        rerun = float((got[1].float() - again[1].float()).abs().max())
        return got, err, scale, rerun

    entries = []
    for cname, cfg in (("train", TRAIN), ("dtu", CONFIGS["dtu"]),
                       ("blend", BLEND)):
        proj_ms, dv = rig(cfg, camio)
        for s in range(3):
            for dname, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16)):
                ref, src, rots, trs, depth = stage_inputs(
                    torch, geometry, cfg, proj_ms, dv, s, dtype, gen)
                B, V, D = src.shape[0], src.shape[1], depth.shape[1]
                h, w, C = ref.shape[1], ref.shape[2], ref.shape[3]
                g = torch.randn((B, V, D, h, w), generator=gen,
                                device="cuda").to(dtype)
                what = f"{cname} stage{s + 1} {dname}"
                stats = torch.zeros(3, dtype=torch.int64, device="cuda")
                _, err, scale, rerun = check(what, ref, src, rots, trs,
                                             depth, g, dname, stats)
                taps = valid_taps(torch, geometry, rots, trs, depth, h, w)
                tapped = tapped_texels(torch, geometry, rots, trs, depth, h,
                                       w)
                esz = ref.element_size()
                byts = (2 * ref.numel() + tapped * C + src.numel()
                        + g.numel()) * esz \
                    + unique_bytes(depth) + (rots.numel() + trs.numel()) * 4
                bms, bby = bound(byts, 20 * g.numel() + 4 * C * taps, dname)
                grad = plain_bwd(torch, cuda_warp, ref, src, rots, trs, depth)
                entries.append(dict(
                    name="warp_correlate_bwd", route="cuda",
                    source="effi_mvs_plus_tpu_torch/csrc/"
                           "warp_correlate_bwd.cu",
                    replaces="effi_mvs_plus_tpu/ops/pallas_warp.py:777",
                    config=cname, stage=s + 1, dtype=dname,
                    shape=f"B{B} V{V} D{D} {h}x{w} C{C}",
                    launches_per_forward=3, atomics=taps * C,
                    src_texels_tapped=tapped / (B * V * h * w),
                    global_atomics=int(stats[1] + stats[2]),
                    window_share=window_share(stats),
                    max_abs_err=err, tolerance=ATOL["warp_correlate_bwd"]
                    * scale, run_to_run_max_abs=rerun,
                    ms=median_ms(torch, lambda: cuda_warp._views_bwd_cuda(
                        ref, src, rots, trs, depth, g), 21),
                    plain_ms=median_ms(torch, lambda: grad(g), 3),
                    bound_ms=bms, bound_by=bby, library_ms=None))
                log({"phase": "kernels", **entries[-1]})
                del ref, src, depth, g, grad
        torch.cuda.empty_cache()

    # rigs at the training stage-2 shape: off the image, and behind the
    # camera, where every projection equals the ordinary rig's
    proj_ms, dv = rig(TRAIN, camio)
    ref, src, rots, trs, depth = stage_inputs(
        torch, geometry, TRAIN, proj_ms, dv, 1, torch.float32, gen)
    h, w = ref.shape[1], ref.shape[2]
    g = torch.randn((*src.shape[:2], depth.shape[1], h, w), generator=gen,
                    device="cuda")
    ordinary = cuda_warp._views_bwd_cuda(ref, src, rots, trs, depth, g)
    wild = {"off_image": (rots, trs + torch.tensor(
                [0.4 * w * 680.0, 0.2 * h * 680.0, 0.0], device="cuda")),
            "behind": (-rots, -trs)}
    for rname, (r_, t_) in wild.items():
        got, err, _, rerun = check(f"rig {rname}", ref, src, r_, t_, depth,
                                   g, "float32")
        zero = float((got[1] == 0).all(-1).float().mean())
        if rname == "off_image" and not 0.05 < zero < 0.95:
            raise AssertionError(f"K3 off_image: untouched share {zero}")
        if rname == "behind" and not torch.equal(got[0], ordinary[0]):
            raise AssertionError("K3 behind: d_ref differs from the "
                                 "ordinary rig")
        log({"phase": "kernel_rig", "kernel": "warp_correlate_bwd",
             "rig": rname, "max_abs_err": err, "run_to_run_max_abs": rerun,
             "d_src_untouched_share": zero})
    del ref, src, depth, g, ordinary
    torch.cuda.empty_cache()
    return entries


class SyntheticDTU:
    """DTU-training samples made in memory from the seed: noise images on
    the seeded rig of the training config and a slanted-plane ground
    truth in the 430-930 mm band, all pixels valid."""

    def __init__(self, n, camio):
        self.n = n
        self.proj_ms, self.dv = rig(dict(TRAIN, B=1), camio)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(SEED + 1 + i)
        V, H, W = TRAIN["V"], TRAIN["H"], TRAIN["W"]
        d0, a, b = rng.uniform(550, 800), *rng.uniform(-0.1, 0.1, 2)
        depth, mask = {}, {}
        for k, s in (("stage1", 8), ("stage2", 4), ("stage3", 2),
                     ("stage4", 1)):
            yy, xx = np.mgrid[0:H // s, 0:W // s] * s
            depth[k] = np.clip(d0 + a * xx + b * yy, 430, 930).astype(
                np.float32)
            mask[k] = np.ones_like(depth[k])
        return {"imgs": rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32),
                "proj_matrices": {k: v[0] for k, v in self.proj_ms.items()},
                "depth_values": self.dv[0], "depth": depth, "mask": mask}


def grad_rels(grads_a, grads_b):
    """[(rel-l2, cosine, leaf)] of gradients a against b, ascending by
    rel-l2, over the leaves where b is not all zero."""
    rels = []
    for name, want in grads_b.items():
        got = grads_a[name].double()
        want = want.double()
        if float(want.abs().max()) == 0:
            continue
        rels.append((float((got - want).norm() / want.norm()),
                     float((got * want).sum() / (got.norm() * want.norm())),
                     name))
    return sorted(rels)


def compare_grads(loss_k, grads_k, loss_p, grads_p):
    """The gradient-parity criterion of tests/test_torch_train.py: loss
    rtol 2e-4, every leaf rel-l2 < 5e-2 with cosine > 0.999, 90th
    percentile of rel-l2 < 1e-2.  Returns (worst rel-l2, its leaf, p90)."""
    if not abs(loss_k - loss_p) <= 2e-4 * abs(loss_p):
        raise AssertionError(f"training loss: {loss_k} against {loss_p}")
    rels = grad_rels(grads_k, grads_p)
    for rel, cos, name in rels:
        if not (rel < 5e-2 and cos > 0.999):
            raise AssertionError(f"gradient {name}: rel-l2 {rel:.2e} cos "
                                 f"{cos:.6f}")
    p90 = rels[int(0.9 * len(rels))][0]
    if not p90 < 1e-2:
        raise AssertionError(f"gradients: 90th-percentile rel-l2 {p90:.2e}")
    return rels[-1][0], rels[-1][2], p90


def training_path(torch, sd):
    """The train step at the DTU training config from the shipped weights:
    one step's loss and gradients with the kernels against the plain
    versions, then warm-up and timed steps of ``make_train_step`` fed by
    the port's Loader.  Returns the launch counts of the timed run."""
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer

    B = TRAIN["B"]
    warm, timed = TRAIN_STEPS
    loader = Loader(SyntheticDTU(B * (1 + warm + timed), camio), B,
                    num_workers=4)
    batches = iter(loader)
    dev = torch.device("cuda")
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(sd, strict=True)
    model.to(dev)

    def counts():
        n = launch_counts()
        return (n["k1_launches"], n["k3_launches"], n["k2_launches"],
                n["conv3d_reg_launches"])

    # one step's loss and gradients, kernels against plain versions, from
    # the same weights, batch and dropout seed
    first = T.batch_to_device(next(batches), dev)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    (loss_k, loss_p, worst, worst_leaf, p90, loss_k2, rerun, rerun_leaf,
     rerun_p90) = kernels_against_plain(torch, model, first, saved,
                                        rerun=True)
    del first

    # the timed run: launch counts reset just before, read just after
    opt, scheduler, _ = make_optimizer(model, 1e-3, 1000)
    step = T.make_train_step(model, opt, scheduler, seed=SEED, device=dev)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith("running_mean")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    reset_launches()
    for i in range(warm + timed):
        batch = next(batches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch)
        end.record()
        end.synchronize()
        losses.append(float(metrics["loss"]))
        if i >= warm:
            step_ms.append(start.elapsed_time(end))
        if counts() != (3 * (i + 1), 3 * (i + 1), 9 * (i + 1), 0):
            raise AssertionError(f"after {i + 1} steps: K1, K3, K2, "
                                 f"conv3d_reg launched {counts()} times")
    batches.close()
    k1, k3, k2, reg = counts()
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    if not any(not torch.equal(p.detach(), params0[n])
               for n, p in model.named_parameters()):
        raise AssertionError("no parameter changed")
    if not any(not torch.equal(b, stats0[n])
               for n, b in model.named_buffers() if n in stats0):
        raise AssertionError("no BN running statistic changed")
    ms = statistics.median(step_ms)
    log({"phase": "training_path",
         "config": "dtu train B4 V5 640x512 48/8/8 fp32",
         "weights": "checkpoints/model_dtu.npz",
         "loss_kernels": loss_k, "loss_plain": loss_p,
         "grad_worst_rel_l2": worst, "grad_worst_leaf": worst_leaf,
         "grad_p90_rel_l2": p90, "rerun_loss_kernels": loss_k2,
         "rerun_grad_worst_rel_l2": rerun, "rerun_grad_worst_leaf": rerun_leaf,
         "rerun_grad_p90_rel_l2": rerun_p90,
         "steps": warm + timed, "timed": timed,
         "step_ms": step_ms, "samples_per_s": B / (ms / 1e3),
         "losses": losses, "k1_launches": k1, "k3_launches": k3,
         "k2_launches": k2, "conv3d_reg_launches": reg,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return {"k1_launches": k1, "k2_launches": k2, "k3_launches": k3,
            "conv3d_reg_launches": reg}


def kernels_against_plain(torch, model, batch, saved, rerun=False):
    """One train step's loss and gradients (forward + ``mvs_loss`` +
    backward, from the weights ``saved``, dropout drawn from SEED) with
    the kernels against the same step with the plain versions
    (``compare_grads``); with ``rerun``, the kernel step again against the
    first (K3's and the convolutions' backward add in no fixed order, so
    that is the run-to-run spread).  Leaves the model at ``saved``.
    Returns (loss with the kernels, plain loss, worst rel-l2, its leaf,
    p90[, rerun loss, rerun worst rel-l2, its leaf, rerun p90])."""
    from effi_mvs_plus_tpu_torch import nn
    from effi_mvs_plus_tpu_torch.ops import cuda_conv, cuda_gru, cuda_warp
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss

    def counts():
        n = launch_counts()
        return (n["k1_launches"], n["k3_launches"], n["k2_launches"],
                n["conv3d_reg_launches"])

    def loss_and_grads():
        model.load_state_dict(saved)      # a train forward moves BN stats
        model.zero_grad(set_to_none=True)
        model.train()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        nn.use_generator(model, gen)
        out = model(batch["imgs"], batch["proj_matrices"],
                    batch["depth_values"])
        loss, _ = mvs_loss(out["depth"], batch["depth"], batch["mask"])
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    reset_launches()
    loss_k, grads_k = loss_and_grads()
    if counts() != (3, 3, 9, 0):
        raise AssertionError(f"one step launched K1, K3, K2, conv3d_reg "
                             f"{counts()} times, not 3, 3, 9, 0")
    with plain_kernels(cuda_warp, cuda_gru, cuda_conv):
        loss_p, grads_p = loss_and_grads()
    if counts() != (3, 3, 9, 0):
        raise AssertionError("the plain step launched a kernel")
    out = (loss_k, loss_p,
           *compare_grads(loss_k, grads_k, loss_p, grads_p))
    del grads_p
    if rerun:
        loss_k2, grads_k2 = loss_and_grads()
        out += (loss_k2, *compare_grads(loss_k2, grads_k2, loss_k, grads_k))
        del grads_k2
    del grads_k
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    return out


def check_chain(what, got, want, dtype, x, specs):
    """Hold K4 against its plain version, elementwise:
    |kernel - plain| <= (5e-5 + layers * 2^-8 [bf16]) * max(|plain|, 1).

    fp32: the same fp32 sums (9*Ci products a layer) in another order; 5e-5
    is the JAX package's bound for its fused chain against XLA
    (tests/test_pallas_conv.py:29), taken relative to the values, which
    reach tens in the deeper levels.  bf16: each layer's output is rounded
    to bf16 (2^-8 relative) in both, and a value that rounds the other way
    in one layer moves the next by as much.  A value within fp32 noise of
    a rounding boundary may round either way in either of them, and the
    next layer's outputs it reaches move by that ulp times a weight, so in
    bf16 the kernel must lie within the tolerance of [lo, hi], the range
    over both roundings of every such value, layer after layer
    (``rounding_bounds.chain_bounds``, float64; lo = hi at an output that
    reads none).  Returns (max abs error, outputs past the tolerance of
    the plain version, values with two roundings)."""
    rel = ATOL["conv_chain"] + len(specs) * RTOL[dtype]
    tol = rel * want.float().abs().clamp(min=1.0)
    diff = (got.float() - want.float()).abs()
    if dtype == "bfloat16":
        from effi_mvs_plus_tpu_torch.ops import rounding_bounds
        lo, hi, two = bounds_in_slices(rounding_bounds.chain_bounds, (x,),
                                       (specs,), got.numel())
        beyond = check_within(f"conv_chain {what}", got, want.float(), lo,
                              hi, tol)
        return float(diff.max()), beyond, two
    excess = float((diff - tol).max())
    if not excess <= 0:
        raise AssertionError(
            f"conv_chain {what}: kernel differs from plain beyond {rel:.3g} "
            f"max(|plain|, 1) (by {excess:.3e}, max abs "
            f"{float(diff.max()):.3e})")
    return float(diff.max()), 0, 0


# the stem chains in the order a forward launches them
CHAIN_NAMES = tuple(f"{net} conv{i}" for net in ("feature", "cnet")
                    for i in range(4))


def record_chains(model, imgs):
    """Both FPNs of an eval model on imgs (B,V,H,W,3), as an inference
    forward runs them; returns [(name, input, folded layers, the ConvBlocks the
    chain stands for)] for each K4 launch."""
    from effi_mvs_plus_tpu_torch.ops import cuda_conv
    calls = []
    real = cuda_conv.conv_bn_relu_chain

    def record(x, specs, packed=None):
        calls.append((x, specs))
        return real(x, specs, packed)
    cuda_conv.conv_bn_relu_chain = record
    try:
        B, V, H, W, _ = imgs.shape
        model.feature(imgs.reshape(B * V, H, W, 3))
        model.cnet_depth(imgs[:, 0])
    finally:
        cuda_conv.conv_bn_relu_chain = real
    blocks = [list(getattr(net, f"conv{i}"))[min(i, 1):]
              for net in (model.feature, model.cnet_depth) for i in range(4)]
    if len(calls) != len(CHAIN_NAMES):
        raise AssertionError(f"the fused FPNs launched {len(calls)} chains")
    return [(n, x, specs, b)
            for n, (x, specs), b in zip(CHAIN_NAMES, calls, blocks)]


def conv_chain_phases(torch, root, gen):
    """K4 against its plain version at every chain of both FPNs at the T&T
    and DTU eval configs (fp32 and bf16), on the inputs and folded
    checkpoint weights an inference forward hands it; library_ms is the
    unfused cuDNN chain (conv + BN + ReLU a layer) the model runs in its
    place when grad is on."""
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model
    from effi_mvs_plus_tpu_torch.ops import conv_pack, cuda_conv

    entries = []
    for cname, ckpt in (("tnt", "model_tank.npz"), ("dtu", "model_dtu.npz")):
        cfg = CONFIGS[cname]
        model = build_model(
            load_npz_checkpoint(os.path.join(root, "checkpoints", ckpt)),
            EffiMVSConfig(ndepths=cfg["ndepths"]), device="cuda")
        imgs = torch.rand((cfg["B"], cfg["V"], cfg["H"], cfg["W"], 3),
                          generator=gen, device="cuda")
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            for name, x, specs, blocks in record_chains(model,
                                                        imgs.to(dtype)):
                packed = cuda_conv.pack(specs, x.dtype)

                def k4(packed=packed):
                    return cuda_conv.conv_bn_relu_chain(x, specs, packed)

                def plain():
                    return cuda_conv._chain_torch(x, specs)

                def cudnn():
                    y = x
                    for blk in blocks:
                        y = blk(y)
                    return y
                err, beyond, two = check_chain(f"{cname} {name} {dname}",
                                               k4(), plain(), dname, x, specs)
                chans = (x.shape[-1],) + tuple(w.shape[0] for w, _ in specs)
                npx = x.shape[0] * x.shape[1] * x.shape[2]
                flops = 18 * npx * sum(a * b for a, b in zip(chans[:-1],
                                                             chans[1:]))
                byts = npx * (chans[0] + chans[-1]) * x.element_size() \
                    + sum((w.numel() + b.numel()) * 4 for w, b in specs)
                bms, bby = bound(byts, flops, dname)
                ms = median_ms(torch, k4, 5)
                entries.append(dict(
                    name="conv_chain", route="cuda",
                    cuda_route="+".join(
                        "mma" if conv_pack.mma_route(x.dtype, a, b) else "fma"
                        for a, b in zip(chans[:-1], chans[1:])),
                    source="effi_mvs_plus_tpu_torch/csrc/conv_chain.cu",
                    replaces="effi_mvs_plus_tpu/ops/pallas_conv.py:78",
                    config=cname, chain=name, dtype=dname,
                    shape=f"B{x.shape[0]} {x.shape[1]}x{x.shape[2]} "
                          + "-".join(map(str, chans)),
                    launches_per_forward=len(CHAIN_NAMES),
                    max_abs_err=err, beyond_plain_tolerance=beyond,
                    two_roundings=two, ms=ms,
                    pack_ms=median_ms(torch, lambda: k4(None), 5),
                    plain_ms=median_ms(torch, plain, 3),
                    bound_ms=bms, bound_by=bby, share_of_bound=bms / ms,
                    library_ms=median_ms(torch, cudnn, 3)))
                log({"phase": "kernels", **entries[-1]})
        del model, imgs
        torch.cuda.empty_cache()
    return entries


# the serving cells' shapes (portbench's dtu_eval-b6 and tnt_eval_fp32-b2,
# in both dtypes) for the fused 3-D layers: B, H, W, stage-1 hypotheses
# and the weights; the CSP blocks run at stages 2 and 3 on 8 hypotheses
REG_CONFIGS = {"tnt": dict(B=2, H=1056, W=1920, D=96, ckpt="model_tank.npz"),
               "dtu": dict(B=6, H=1184, W=1600, D=48, ckpt="model_dtu.npz")}


def check_reg(what, got, want, dtype):
    """A fused 3-D layer against its plain version, elementwise, at the
    card tests' tolerance (tests/test_torch_conv3d_reg_cuda.py): fp32
    1e-5 of the largest output plus 1e-6 of each (the same fp32 sums in
    another order); bf16 one bf16 step of each output (2^-7: a sum within
    fp32 noise of a rounding boundary may round either way) plus 1e-5 of
    the largest.  Returns the max abs error."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    tol = (1e-5 * scale + 1e-6 * want.abs() if dtype == "float32"
           else 2.0 ** -7 * want.abs() + 1e-5 * scale)
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(
            f"conv3d_reg {what}: kernel differs from plain beyond the "
            f"tolerance (by {float((err - tol).max()):.3e}, max abs "
            f"{float(err.max()):.3e})")
    return float(err.max())


def conv3d_reg_phases(torch, root, gen):
    """The fused 3-D layers (``ops/cuda_conv3d.py``) against their plain
    version at every layer of CostRegNet (stage 1) and of a CSP block at
    stages 2 and 3, at the serving cells' shapes (``REG_CONFIGS``), fp32
    and bf16, on the inputs and checkpoint weights a served forward hands
    them (seeded volumes in place of the warps' similarities); library_ms
    is the layer through the blocks (cuDNN, BN, ReLU, the residual add,
    the cat), the path with grad on."""
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model
    from effi_mvs_plus_tpu_torch.ops import conv_pack, cuda_conv3d

    entries = []
    real = cuda_conv3d.conv3d_reg
    for cname, c in REG_CONFIGS.items():
        model = build_model(
            load_npz_checkpoint(os.path.join(root, "checkpoints", c["ckpt"])),
            EffiMVSConfig(ndepths=(c["D"], 8, 8)), device="cuda")
        B, H, W = c["B"], c["H"], c["W"]

        def vol(d, h, w):
            return torch.rand((B, d, h, w, 1), generator=gen, device="cuda")
        runs = (("cost_regularization", (vol(c["D"], H // 8, W // 8),)),
                ("CSP_R1", (vol(8, H // 4, W // 4), vol(8, H // 8, W // 8))),
                ("CSP_R2", (vol(8, H // 2, W // 2), vol(8, H // 4, W // 4))))
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            for mname, vols in runs:
                module = getattr(model, mname)
                calls = []

                def record(x, layer, x2=None, res=None):
                    calls.append((x, layer, x2, res))
                    return real(x, layer, x2, res)
                cuda_conv3d.conv3d_reg = record
                try:
                    module(*(v.to(dtype) for v in vols))
                finally:
                    cuda_conv3d.conv3d_reg = real
                if len(calls) != len(module.LAYERS):
                    raise AssertionError(f"{mname}: {len(calls)} conv3d_reg "
                                         f"calls")
                for attr, (x, layer, x2, res) in zip(module.LAYERS, calls):
                    blk = getattr(module, attr)

                    def k(x=x, layer=layer, x2=x2, res=res):
                        return real(x, layer, x2, res)

                    def plain(x=x, layer=layer, x2=x2, res=res):
                        return cuda_conv3d._reg_torch(x, layer, x2, res)

                    def blocks_(x=x, x2=x2, res=res, blk=blk):
                        y = blk(x if x2 is None else torch.cat([x, x2], -1))
                        return y if res is None else res + y
                    out = k()
                    err = check_reg(f"{cname} {mname}.{attr} {dname}", out,
                                    plain(), dname)
                    ci, co = layer.channels
                    taps = (27 / math.prod(layer.stride) if layer.transpose
                            else 27)
                    flops = 2 * out.numel() * ci * taps
                    byts = sum(t.numel() * t.element_size()
                               for t in (x, x2, res, out) if t is not None)
                    bms, bby = bound(byts, flops, dname)
                    ms = median_ms(torch, k, 5)
                    entries.append(dict(
                        name="conv3d_reg", route="cuda",
                        cuda_route="mma" if conv_pack.mma_route(
                            dtype, ci, co) else "fma",
                        source="effi_mvs_plus_tpu_torch/csrc/conv3d_reg.cu",
                        replaces=None, config=cname,
                        layer=f"{mname}.{attr}", dtype=dname,
                        shape=f"{tuple(x.shape)} -> {tuple(out.shape)}",
                        launches_per_forward=25, max_abs_err=err, ms=ms,
                        plain_ms=median_ms(torch, plain, 3),
                        bound_ms=bms, bound_by=bby, share_of_bound=bms / ms,
                        library_ms=median_ms(torch, blocks_, 3)))
                    log({"phase": "kernels", **entries[-1]})
                del calls
        del model, runs
        torch.cuda.empty_cache()
    return entries


def stem_ab(torch, sd):
    """The DTU eval forward (B=6, on the card's copy of the request) with
    the fused stem, under inference mode as the engine serves it, and with
    the unfused conv + BN + ReLU blocks, which the FPN takes when grad is
    on (the parameters frozen, so nothing is recorded); fp32 and bf16,
    timed in turns (off on on off off on, after a warm-up of each)."""
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.models import (EffiMVSConfig, build_model,
                                                freeze_kernel_weights)
    from effi_mvs_plus_tpu_torch.utils import profiling

    batch = dtu_batch(camio)
    args = (torch.from_numpy(batch["imgs"]).cuda(),
            {k: torch.from_numpy(batch["proj_matrices"][k]).cuda()
             for k in ("stage1", "stage2", "stage3")},
            torch.from_numpy(batch["depth_values"]).cuda())
    out = {"phase": "dtu_fused_stem", "config": "dtu B6 V5 1152x864 48/8/8"}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = freeze_kernel_weights(build_model(
            sd, EffiMVSConfig(compute_dtype=dtype), device="cuda"))

        def forward(on):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            n = profiling.counter("k4.launches")
            with torch.inference_mode() if on else torch.enable_grad():
                start.record()
                depth = model(*args)["depth"][-1]
                end.record()
            end.synchronize()
            n = profiling.counter("k4.launches") - n
            if n != (len(CHAIN_NAMES) if on else 0):
                raise AssertionError(f"fused stem {on}: {n} K4 launches")
            return start.elapsed_time(end), depth

        times, depth = {False: [], True: []}, {}
        for on in (False, True):
            forward(on)
        for on in (False, True, True, False, False, True):
            ms, depth[on] = forward(on)
            times[on].append(ms)
        diff = (depth[True] - depth[False]).abs()
        out[dname] = {
            "forward_ms_off": times[False], "forward_ms_on": times[True],
            "maps_per_s_off": 6e3 / statistics.median(times[False]),
            "maps_per_s_on": 6e3 / statistics.median(times[True]),
            "on_vs_off_median_depth_abs": float(diff.median()),
            "on_vs_off_max_depth_abs": float(diff.max())}
    log(out)


def make_texture(rng, size=512):
    """Multi-octave noise texture (tests/synth_scene.py's recipe)."""
    tex = np.zeros((size, size, 3))
    for cells in (size, size // 4, size // 16, size // 64):
        oct_ = rng.uniform(0, 1, (cells, cells, 3))
        reps = size // cells
        tex += np.repeat(np.repeat(oct_, reps, 0), reps, 1)
    tex -= tex.min()
    return tex / tex.max()


def look_at_extrinsic(cam_center, target):
    """World->cam extrinsic whose optical axis points at `target` (y-down
    image convention, yaw/pitch only)."""
    z = np.asarray(target, np.float64) - np.asarray(cam_center, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = np.stack([x, y, z]).astype(np.float32)
    E[:3, 3] = (-E[:3, :3] @ np.asarray(cam_center, np.float32))
    return E


def render_plane(torch, K, E, H, W, z, tex, texel):
    """The textured world plane Z = z through camera (K, E), ray-cast on
    the card in float64 with a bilinear, wrapping texture lookup; uint8
    (H, W, 3)."""
    dev = tex.device
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    Kt = torch.as_tensor(K, dtype=f64, device=dev)
    R = torch.as_tensor(E[:3, :3], dtype=f64, device=dev)
    t = torch.as_tensor(E[:3, 3], dtype=f64, device=dev)
    dirs = R.T @ (torch.linalg.inv(Kt) @ pix)
    origin = -R.T @ t
    pts = origin[:, None] + dirs * ((z - origin[2]) / dirs[2])
    n = tex.shape[0]
    u = torch.remainder(pts[0] / texel, n)
    v = torch.remainder(pts[1] / texel, n)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[:, None], (v - v0)[:, None]
    # a remainder of a tiny negative value rounds up to n itself
    u0, v0 = u0.long() % n, v0.long() % n
    u1, v1 = (u0 + 1) % n, (v0 + 1) % n
    img = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
           + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)
    return (img.reshape(H, W, 3) * 255).to(torch.uint8).cpu().numpy()


def render_tank_scene(torch, root, camio):
    """tests/synth_scene.build_tank_scene's rig at the TANK point, in the
    Tanks & Temples layout <root>/intermediate/Horse/{images,cams,
    pair.txt}: cameras on a line at z = 0, `baseline` apart, aimed at the
    plane point in front of camera 0; 4-field cam line 11."""
    from PIL import Image
    H, W, V, z = TANK["H"], TANK["W"], TANK["V"], TANK["plane_z"]
    scene_dir = os.path.join(root, "intermediate", "Horse")
    for d in ("images", "cams"):
        os.makedirs(os.path.join(scene_dir, d))
    f = TANK["focal_mult"] * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    tex = torch.as_tensor(make_texture(np.random.default_rng(SEED)),
                          device="cuda")
    dmin, dmax = TANK["band"]
    for v in range(V):
        b = TANK["baseline"]
        E = look_at_extrinsic([b * v, b / 4.0 * v, 0.0], [0.0, 0.0, z])
        Image.fromarray(render_plane(torch, K, E, H, W, z, tex,
                                     2.0 * z / f)).save(
            os.path.join(scene_dir, "images", f"{v:08d}.jpg"), quality=95)
        camio.write_cam_file(
            os.path.join(scene_dir, "cams", f"{v:08d}_cam.txt"), E, K,
            [dmin, (dmax - dmin) / 192.0, 192.0, dmax])
    with open(os.path.join(scene_dir, "pair.txt"), "w") as fh:
        fh.write(f"{V}\n")
        for v in range(V):
            srcs = sorted((s for s in range(V) if s != v),
                          key=lambda s: abs(s - v))
            fh.write(f"{v}\n{len(srcs)} "
                     + " ".join(f"{s} 10.0" for s in srcs) + "\n")


def score_tank_ply(path):
    """The fused cloud (m -> mm) against the plane, as
    tests/test_e2e_tank_accuracy.py scores it: the plane sampled over the
    inset footprint of camera 0, a permissive voxel mask, dst 2 mm.
    Returns (ScanResult, points scored, ground-truth points)."""
    from effi_mvs_plus_tpu_torch.eval import dtu
    from effi_mvs_plus_tpu_torch.fuse.ply import read_ply
    H, W = TANK["H"], TANK["W"]
    method = np.asarray(read_ply(path)[0], np.float64) * 1000.0
    f = TANK["focal_mult"] * W
    plane_mm = TANK["plane_z"] * 1000.0
    half_x, half_y = (W / 2 - 1) / f * plane_mm, (H / 2 - 1) / f * plane_mm
    sp, inset = TANK["gt_spacing_mm"], 30.0
    xs = np.arange(-half_x + inset, half_x - inset, sp)
    ys = np.arange(-half_y + inset, half_y - inset, sp)
    gx, gy = np.meshgrid(xs, ys)
    stl = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, plane_mm)], 1)
    bb = np.array([[xs[0] - 100, ys[0] - 100, plane_mm - 200],
                   [xs[-1] + 100, ys[-1] + 100, plane_mm + 200]])
    obs = np.ones(tuple(np.ceil((bb[1] - bb[0]) / 10.0).astype(int) + 2),
                  bool)
    r = dtu.evaluate_scan(method, stl, obs, bb, 10.0,
                          np.array([0.0, 0.0, 1.0, -(plane_mm - 150.0)]),
                          dst=2.0, max_dist=100.0)
    return r, len(method), len(stl)


def tank_path(torch, root):
    """The T&T reconstruction chain through the CLI's own functions, with
    the kernel launch counts reset just before inference and read just
    after; then the fusion, the score against the plane, and the fp32
    in-place check.  Returns the launch counts."""
    from effi_mvs_plus_tpu_torch.cli import test_tank
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.datasets import TanksDataset
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise RuntimeError("the T&T reader decodes JPEGs with PIL, which "
                           "this machine lacks") from e

    V = TANK["V"]
    with tempfile.TemporaryDirectory() as work:
        data, out = os.path.join(work, "tt"), os.path.join(work, "out")
        t0 = time.perf_counter()
        render_tank_scene(torch, data, camio)
        render_s = time.perf_counter() - t0
        args = test_tank.build_parser().parse_args([
            "--device", "cuda", "--testpath", data,
            "--loadckpt", os.path.join(root, "checkpoints", "model_tank.npz"),
            "--outdir", out, "--scenes", "Horse", "--num_view", str(V),
            "--max_h", str(TANK["H"]), "--max_w", str(TANK["W"])])
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stats = test_tank.save_depths(args)["Horse"]
        counts = {k: v for k, v in launch_counts().items()
                  if k != "k3_launches"}
        maps = stats["maps"]
        if maps != V or tuple(counts.values()) != (3 * maps, 9 * maps,
                                                   8 * maps, 25 * maps):
            raise AssertionError(f"T&T path: {maps} maps, launches {counts}")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # the host reader's share: one request's 11 views decoded alone
        t0 = time.perf_counter()
        TanksDataset(data, ["Horse"], V, args.numdepth,
                     target_wh=(TANK["W"], TANK["H"]))[0]
        reader_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ply, n_points = test_tank.fuse_scene_tank(args, "Horse")
        fusion_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r, n_method, n_stl = score_tank_ply(ply)
        eval_s = time.perf_counter() - t0
        overall = (r.acc_mean + r.comp_mean) / 2
        if not (n_points > 500 and overall < TANK_SPACING_MM / 2):
            raise AssertionError(f"T&T: {n_points} points, overall "
                                 f"{overall} mm (bound "
                                 f"{TANK_SPACING_MM / 2:.1f})")
        log({"phase": "tank_path", "route": "files: TanksDataset decodes "
             "the rendered JPEGs with PIL",
             "config": f"T&T B1 V{V} {TANK['W']}x{TANK['H']} 96/8/8 bf16",
             "weights": "checkpoints/model_tank.npz",
             "filter": "TANK_FILTER_CONFIGS['Horse']", "maps": maps,
             **counts, "render_s": render_s,
             "save_depths_s": stats["total_s"],
             "maps_per_s": maps / stats["total_s"],
             "device_maps_per_s": maps / stats["device_s"],
             "reader_s_per_request": reader_s,
             "fusion_s": fusion_s, "eval_s": eval_s, "points": n_points,
             "points_scored": n_method, "gt_points": n_stl,
             "overall_mm": overall, "acc_mm": r.acc_mean,
             "comp_mm": r.comp_mean, "bound_mm": TANK_SPACING_MM / 2,
             "inference_peak_mem_gb": peak_gb})
        with torch.inference_mode():
            tank_inplace(torch, root, data)
        a12_phase(torch, data, os.path.join(out, "Horse"))
    torch.cuda.empty_cache()
    return counts


def a12_phase(torch, data, scene_out):
    """The static and legacy fusion on the T&T path's saved maps (the first
    reference of pair.txt and its first 4 sources, 1920x1056): each call
    on the card against the same call on the CPU; then the native data
    plane's resize of one 1920x1080 view to the T&T reader's 1920x1056
    against the reader's numpy resize, both timed on this host."""
    from effi_mvs_plus_tpu_torch import native
    from effi_mvs_plus_tpu_torch.data import read_cam_file, read_pair_file
    from effi_mvs_plus_tpu_torch.data.datasets import (_resize_bilinear,
                                                       tank_split)
    from effi_mvs_plus_tpu_torch.data.pfm import read_pfm
    from effi_mvs_plus_tpu_torch.fuse import legacy, static
    t0 = time.perf_counter()
    ref, srcs = read_pair_file(os.path.join(data, tank_split("Horse"),
                                            "Horse", "pair.txt"))[0]
    views = []
    for vid in [ref] + srcs[:4]:
        cam = read_cam_file(os.path.join(scene_out, "cams",
                                         f"{vid:08d}_cam.txt"))
        depth = read_pfm(os.path.join(scene_out, "depth_est",
                                      f"{vid:08d}.pfm"))[0]
        conf = read_pfm(os.path.join(scene_out, "confidence",
                                     f"{vid:08d}.pfm"))[0]
        conf = np.repeat(np.repeat(conf, depth.shape[0] // conf.shape[0],
                                   0), depth.shape[1] // conf.shape[1], 1)
        proj = np.zeros((2, 4, 4), np.float32)
        proj[0], proj[1, :3, :3], proj[1, 3, 3] = (cam["extrinsics"],
                                                  cam["intrinsics"], 1.0)
        views.append((depth, conf, cam["intrinsics"], cam["extrinsics"],
                      proj))

    def t(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    r, sv = views[0], views[1:]
    stat_args = {dev: (t(r[0], dev), t(r[1], dev), t(r[2], dev),
                       t(r[3], dev), t(np.stack([v[0] for v in sv]), dev),
                       t(np.stack([v[2] for v in sv]), dev),
                       t(np.stack([v[3] for v in sv]), dev))
                 for dev in ("cuda", "cpu")}
    leg_args = {dev: (t(r[0], dev), t(np.stack([v[0] for v in sv]), dev),
                      t(r[4], dev), t(np.stack([v[4] for v in sv]), dev))
                for dev in ("cuda", "cpu")}

    def flips(a, b):
        return float((a.cpu() != b.cpu()).float().mean())

    def share_over(a, b, tol):
        return float(((a.cpu() - b.cpu()).abs() > tol).float().mean())

    # the card and the CPU round the fp32 geometry differently (FMAs, the
    # 4x4 LU inverse): a value moves by a few ulps, and where it is
    # sampled from a steep field (a cloud or a coordinate map at a depth
    # edge) by a few 1e-5 of its scale; the masks, the decisions, stay

    out = {"phase": "a12", "config": "T&T Horse maps 1920x1056, ref "
           f"{ref}, sources {srcs[:4]}"}
    xyd = [static.get_reproj(*(stat_args[dev][i] for i in (0, 2, 3, 4, 5,
                                                          6)))
           for dev in ("cuda", "cpu")]
    card, cpu = (static.consistency_static(*stat_args[dev])
                 for dev in ("cuda", "cpu"))
    scale = float(np.abs(views[0][0]).max())
    xyd_scale = xyd[1][0].abs().amax((0, 1, 2))      # x, y, depth
    out["static"] = {
        "reproj_in_range_flips": flips(xyd[0][1], xyd[1][1]),
        "reproj_share_over_1e-5_scale": share_over(
            xyd[0][0], xyd[1][0], 1e-5 * xyd_scale),
        "reproj_max_abs": float((xyd[0][0].cpu() - xyd[1][0]).abs().max()),
        **{f"{k}_flips": flips(a, b) for k, a, b in zip(
            ("final", "geo", "photo"), (card[0], card[2], card[3]),
            (cpu[0], cpu[2], cpu[3]))},
        "fused_share_over_1e-5_scale": share_over(card[1], cpu[1],
                                                  1e-5 * scale),
        "final_share": float(card[0].float().mean())}
    card, cpu = (legacy.filter_depth(*leg_args[dev])
                 for dev in ("cuda", "cpu"))
    pc_scale = float(cpu[0].abs().max())
    out["legacy"] = {
        "ref_pc_share_over_1e-5_scale": share_over(card[0], cpu[0],
                                                   1e-5 * pc_scale),
        "dist_share_over_1e-4_scale": share_over(card[2], cpu[2],
                                                 1e-4 * pc_scale),
        "dist_share_over_1e-5_scale_info": share_over(card[2], cpu[2],
                                                      1e-5 * pc_scale),
        "dist_max_abs": float((card[2].cpu() - cpu[2]).abs().max()),
        "pc_scale": pc_scale}
    worst = max(v for part in ("static", "legacy") for k, v in
                out[part].items()
                if ("flips" in k or "share_over" in k) and "info" not in k)
    if not worst <= 1e-3:
        raise AssertionError(f"a12: the card against the CPU: {out}")

    t1 = time.perf_counter()
    native.library()
    out["native_build_s"] = time.perf_counter() - t1
    img = np.random.default_rng(SEED).uniform(0, 1, (1080, 1920, 3)).astype(
        np.float32)
    wh = (TANK["W"], TANK["H"])
    got, want = native.resize(img, wh), _resize_bilinear(img, wh)
    out["resize_max_abs"] = float(np.abs(got - want).max())
    if not out["resize_max_abs"] <= 2e-6:
        raise AssertionError(f"a12: native resize: {out}")
    for name, fn in (("native", native.resize),
                     ("numpy", _resize_bilinear)):
        times = []
        for _ in range(7):
            t1 = time.perf_counter()
            fn(img, wh)
            times.append(time.perf_counter() - t1)
        out[f"resize_{name}_ms"] = statistics.median(times) * 1e3
    out["host_threads"] = os.cpu_count()
    out["seconds"] = time.perf_counter() - t0
    log(out)


def tank_inplace(torch, root, data):
    """One fp32 forward at the T&T config with every kernel (K4 included)
    against the same forward with every plain version, on the rendered
    scene's first request: all 13 depth maps within the golden tolerance
    (tests/test_model_golden.py: 0.5% of the map's range plus 0.5 mm,
    here in metres)."""
    from effi_mvs_plus_tpu_torch.data.datasets import TanksDataset
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model
    from effi_mvs_plus_tpu_torch.ops import cuda_conv, cuda_gru, cuda_warp

    sample = TanksDataset(data, ["Horse"], TANK["V"], ND,
                          target_wh=(TANK["W"], TANK["H"]))[0]
    args = (torch.from_numpy(sample["imgs"][None]).cuda(),
            {k: torch.from_numpy(sample["proj_matrices"][k][None]).cuda()
             for k in ("stage1", "stage2", "stage3")},
            torch.from_numpy(sample["depth_values"][None]).cuda())
    model = build_model(
        load_npz_checkpoint(os.path.join(root, "checkpoints",
                                         "model_tank.npz")),
        EffiMVSConfig(ndepths=(96, 8, 8)), device="cuda")
    out_k = model(*args)
    n = launch_counts()
    with plain_kernels(cuda_warp, cuda_gru, cuda_conv):
        out_p = model(*args)
    if launch_counts() != n:
        raise AssertionError("the plain forward launched a kernel")
    _, worst = check_depth_maps("T&T", out_k, out_p, 5e-4)
    conf_diff = (out_k["photometric_confidence"]
                 - out_p["photometric_confidence"]).abs()
    log({"phase": "tank_inplace",
         "config": f"T&T B1 V{TANK['V']} {TANK['W']}x{TANK['H']} 96/8/8 fp32",
         "worst_depth_err_over_tolerance": worst,
         "median_depth_abs_m": float((out_k["depth"][-1]
                                      - out_p["depth"][-1]).abs().median()),
         "conf_max_abs": float(conf_diff.max()),
         "conf_share_over_5e-3": float((conf_diff >= 5e-3).float().mean())})


def plane_depth(torch, K, E, H, W, z):
    """The camera-space depth of the world plane Z = z through camera
    (K, E) at every pixel, float64 on the card; float32 (H, W)."""
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device="cuda"),
                            torch.arange(W, dtype=f64, device="cuda"),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    Kt = torch.as_tensor(K, dtype=f64, device="cuda")
    R = torch.as_tensor(E[:3, :3], dtype=f64, device="cuda")
    t = torch.as_tensor(E[:3, 3], dtype=f64, device="cuda")
    dirs = R.T @ (torch.linalg.inv(Kt) @ pix)
    origin = -R.T @ t
    pts = origin[:, None] + dirs * ((z - origin[2]) / dirs[2])
    return (R @ pts + t[:, None])[2].reshape(H, W).float().cpu().numpy()


def render_blend_tree(torch, root, camio):
    """A BlendedMVS tree at the blend_finetune size (768x576) in
    <root>/<scan>/{blended_images,cams,rendered_depth_maps}: the textured
    plane of the T&T rig seen by BLEND_TREE's cameras on a line, each aimed
    at the plane point in front of the middle one, with the plane's depth
    as ground truth and a 4-field cam line 11.  Returns the list file."""
    from PIL import Image
    from effi_mvs_plus_tpu_torch.data.pfm import save_pfm
    H, W, n = BLEND["H"], BLEND["W"], BLEND_TREE["views"]
    z, (dmin, dmax) = BLEND_TREE["plane_z"], BLEND_TREE["band"]
    base = os.path.join(root, BLEND_TREE["scan"])
    for d in ("blended_images", "cams", "rendered_depth_maps"):
        os.makedirs(os.path.join(base, d))
    f = BLEND_TREE["focal_mult"] * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    tex = torch.as_tensor(make_texture(np.random.default_rng(SEED + 2)),
                          device="cuda")
    b = BLEND_TREE["baseline"]
    for v in range(n):
        E = look_at_extrinsic([b * (v - n // 2), b / 4.0 * v, 0.0],
                              [0.0, 0.0, z])
        Image.fromarray(render_plane(torch, K, E, H, W, z, tex,
                                     2.0 * z / f)).save(
            os.path.join(base, "blended_images", f"{v:08d}.jpg"), quality=95)
        save_pfm(os.path.join(base, "rendered_depth_maps", f"{v:08d}.pfm"),
                 plane_depth(torch, K, E, H, W, z))
        camio.write_cam_file(os.path.join(base, "cams", f"{v:08d}_cam.txt"),
                             E, K, [dmin, (dmax - dmin) / 192.0, 192.0, dmax])
    with open(os.path.join(base, "cams", "pair.txt"), "w") as fh:
        fh.write(f"{n}\n")
        for v in range(n):
            srcs = sorted((s for s in range(n) if s != v),
                          key=lambda s: abs(s - v))
            fh.write(f"{v}\n{len(srcs)} "
                     + " ".join(f"{s} 10.0" for s in srcs) + "\n")
    listfile = os.path.join(root, "list.txt")
    with open(listfile, "w") as fh:
        fh.write(BLEND_TREE["scan"] + "\n")
    return listfile


def blend_batch(tree, listfile):
    """The first B=8 samples of the tree's training split (the reader's
    ``train`` mode: each ref's first 6 sources), collated by the Loader."""
    from effi_mvs_plus_tpu_torch.data.datasets import BlendedMVSDataset
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    ds = BlendedMVSDataset(tree, listfile, "train", BLEND["V"], ND)
    batch = next(iter(Loader(ds, BLEND["B"], num_workers=8)))
    batch.pop("filename")
    return batch


_LAUNCHES_FROM = {}


# the kernel wrappers' launch counters (``<name>.launches``)
KERNELS = ("k1", "k2", "k3", "k4", "conv3d_reg")


def launch_counts():
    """Every kernel wrapper's launches (the tracer's ``kN.launches`` and
    ``conv3d_reg.launches`` counters) since the last ``reset_launches``."""
    from effi_mvs_plus_tpu_torch.utils import profiling
    return {f"{k}_launches": profiling.counter(f"{k}.launches")
            - _LAUNCHES_FROM.get(k, 0) for k in KERNELS}


def reset_launches():
    from effi_mvs_plus_tpu_torch.utils import profiling
    _LAUNCHES_FROM.update({k: profiling.counter(f"{k}.launches")
                           for k in KERNELS})


def timed_cli(torch, argv):
    """``cli/train.py``'s ``main(argv)`` with every training step it runs
    timed by CUDA events, the launch counts reset just before and read
    just after: (step ms, the host clock when each step had finished,
    the launch counts, seconds)."""
    from effi_mvs_plus_tpu_torch.cli import train as cli
    from effi_mvs_plus_tpu_torch.train import trainer as T
    real = T.make_train_step
    step_ms, step_done = [], []

    def timed_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def run_step(batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(batch)
            end.record()
            end.synchronize()
            step_done.append(time.perf_counter())
            step_ms.append(start.elapsed_time(end))
            return metrics
        return run_step

    t0 = time.perf_counter()
    T.make_train_step = timed_step
    reset_launches()
    try:
        cli.main(argv)
    finally:
        T.make_train_step = real
    return step_ms, step_done, launch_counts(), time.perf_counter() - t0


def finetune_path(torch, root, tree, listfile):
    """BlendedMVS fine-tuning through ``cli/train.py``'s own ``main``:
    ``--mode finetune`` (the blend_finetune profile at full width: 768x576,
    7 views, 96/8/8, B=8, fp32) from model_dtu.npz on the rendered tree,
    BLEND_TREE's epochs of 2 steps and an eval batch each, with the launch
    counts reset just before and read just after and each step timed by
    CUDA events; then one step with the kernels against one with the plain
    versions, ``--mode test`` (K4 in its eval forwards) and ``--mode
    profile``.  Returns the launch counts of the fine-tune run and of the
    test run."""
    from effi_mvs_plus_tpu_torch.cli import train as cli
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from effi_mvs_plus_tpu_torch.train import trainer as T

    npz = os.path.join(root, "checkpoints", "model_dtu.npz")
    logdir = os.path.join(tree, "run")
    common = ["--device", "cuda", "--testpath", tree, "--testlist",
              listfile, "--loadckpt", npz, "--num_workers", "8"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_done, ft, ft_s = timed_cli(torch, [
        "--mode", "finetune", "--trainpath", tree, "--trainlist", listfile,
        "--logdir", logdir, "--epochs", str(BLEND_TREE["epochs"]),
        "--summary_freq", "1"] + common)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(step_ms)
    evals = BLEND_TREE["epochs"] * (BLEND_TREE["views"] // BLEND["B"])
    want = {"k1_launches": 3 * (steps + evals),
            "k2_launches": 9 * (steps + evals), "k3_launches": 3 * steps,
            "k4_launches": 8 * evals, "conv3d_reg_launches": 25 * evals}
    if steps != BLEND_TREE["epochs"] * (BLEND_TREE["views"] // BLEND["B"]) \
            or ft != want:
        raise AssertionError(f"fine-tune: {steps} steps, launches {ft} "
                             f"(want {want})")
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"fine-tune losses {losses}")
    if not os.path.exists(os.path.join(
            logdir, f"model_{BLEND_TREE['epochs'] - 1:06d}.ckpt")):
        raise AssertionError("fine-tune: no checkpoint of the last epoch")
    timed = step_ms[1:]            # the first step warms up
    ms = statistics.median(timed)
    # the wall time from one step's end to the next's within an epoch:
    # the CLI's loop (the metrics row, the Loader's wait for the batch),
    # then the step
    per_epoch = steps // BLEND_TREE["epochs"]
    wall_ms = [(step_done[i] - step_done[i - 1]) * 1e3
               for i in range(1, steps) if i % per_epoch]
    log({"phase": "finetune_path",
         "config": "blend_finetune B8 V7 768x576 96/8/8 fp32",
         "weights": "checkpoints/model_dtu.npz",
         "route": "cli/train.py main --mode finetune: BlendedMVSDataset "
                  "decodes the rendered JPEGs with PIL",
         "steps": steps, "eval_batches": evals, "step_ms": step_ms,
         "timed_step_ms": timed, "samples_per_s": BLEND["B"] / (ms / 1e3),
         "samples_per_s_min": BLEND["B"] / (max(timed) / 1e3),
         "samples_per_s_max": BLEND["B"] / (min(timed) / 1e3),
         "wall_step_ms": wall_ms,
         "wall_samples_per_s": BLEND["B"] / (statistics.median(wall_ms)
                                             / 1e3),
         "losses": losses, **ft, "peak_mem_gb": peak_gb,
         "cli_seconds": ft_s})

    # one step at this config: kernels against plain versions
    sd = load_npz_checkpoint(npz)
    model = EffiMVS(EffiMVSConfig(ndepths=BLEND["ndepths"]))
    model.load_state_dict(sd, strict=True)
    model.to("cuda")
    batch = T.batch_to_device(blend_batch(tree, listfile), "cuda")
    loss_k, loss_p, worst, worst_leaf, p90 = kernels_against_plain(
        torch, model, batch, sd)
    del model, batch
    torch.cuda.empty_cache()
    log({"phase": "finetune_vs_plain", "loss_kernels": loss_k,
         "loss_plain": loss_p, "grad_worst_rel_l2": worst,
         "grad_worst_leaf": worst_leaf, "grad_p90_rel_l2": p90})

    # --mode test: the eval suite over the tree, K4 in each eval forward
    reset_launches()
    t0 = time.perf_counter()
    means = cli.main(["--mode", "test", "--dataset", "blend", "--ndepths",
                      "96,8,8", "--testviews", str(BLEND["V"]),
                      "--batch_size", str(BLEND["B"])] + common)
    test = launch_counts()
    n_batches = -(-BLEND_TREE["views"] // BLEND["B"])
    if not (all(np.isfinite(v) for v in means.values())
            and test["k4_launches"] == 8 * n_batches
            and test["conv3d_reg_launches"] == 25 * n_batches
            and test["k1_launches"] == 3 * n_batches):
        raise AssertionError(f"--mode test: {means}, launches {test}")
    log({"phase": "finetune_test_mode", "metrics": means, **test,
         "seconds": time.perf_counter() - t0})

    # --mode profile: timed steps, then a torch.profiler trace
    t0 = time.perf_counter()
    prof_dir = os.path.join(tree, "prof")
    dt = cli.main(["--mode", "profile", "--dataset", "blend", "--ndepths",
                   "96,8,8", "--testviews", str(BLEND["V"]), "--batch_size",
                   "4", "--logdir", prof_dir] + common)
    trace = os.path.join(prof_dir, "trace", "trace.json")
    if not (dt > 0 and os.path.isfile(trace)):
        raise AssertionError(f"--mode profile: {dt} s/step, {trace}")
    log({"phase": "finetune_profile_mode", "batch": 4, "ms_per_step": dt * 1e3,
         "trace_bytes": os.path.getsize(trace),
         "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return ft, test


def distributed_phase(torch, tree, listfile, sd):
    """Two ranks spawned on the one card (gloo on CUDA tensors: NCCL
    refuses two ranks on one device) run the equivalence gate of
    ``parallel/equivalence.py`` with the kernels: a data-parallel
    fine-tune step (4 + 4 of the B=8 batch), a view-sharded one (3 + 3
    sources) and the view-sharded engine on one DTU request (2 + 2
    sources, fp32), then the depth-sharded step (``depth``: each rank
    warps 48 of the 96 stage-1 hypotheses and 4 of the 8 of stages 2-3
    of every view) and the JAX CLI's default ``views,depth`` (3 + 3
    sources, then 48 + 48 planes of the summed volume), then the
    row-sharded step (``spatial``: each rank 288 of the 576 image rows of
    every activation), ``views,spatial`` (3 + 3 sources over all rows,
    then 288 + 288 rows) and the row-sharded engine (416 + 448 of the 864
    rows, K4 on the row blocks), each against this process's
    single-process result.  Before the spawns, K1 runs on each D-block of
    the expanded stage-1 sweep (``depth_block_k1``), and K1 and K3 on the
    row blocks of the fine-tune stage-1 and stage-3 shapes
    (``row_block_kernels``).  Last, in one spawn, ``depth,spatial`` (the
    2-D activations 288 + 288 rows, the volumes 48 + 48 stage-1 and
    4 + 4 later hypotheses over all rows) and ``views,depth,spatial``
    (3 + 3 sources for the FPN, the warps and PixelwiseNet, then D-blocks
    of the summed volumes, then rows), with each rank's peak memory beside
    ``depth``'s and ``spatial``'s and a rank's ``memory_phases``.
    Returns the row-block kernel entries, their launches a rank's
    ``spatial`` step, and the launches of a rank's step in each of the
    two layouts."""
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    from effi_mvs_plus_tpu_torch.ops import cuda_warp
    from effi_mvs_plus_tpu_torch.parallel import equivalence as E
    with torch.inference_mode():
        blocks = depth_block_k1(torch)
    torch.cuda.empty_cache()
    row_blocks, rows_entries = row_block_kernels(torch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    request = dtu_batch(camio)
    request.pop("filename")
    torch.cuda.reset_peak_memory_stats()
    ref = E.references(sd, EffiMVSConfig(ndepths=BLEND["ndepths"]),
                       blend_batch(tree, listfile), "cuda", request,
                       EffiMVSConfig())
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        report = E.spawn(2, ["data", "views", "engine"], ref, work,
                         backend="gloo", device="cuda", timeout=600,
                         threads=4)
        depth = E.spawn(2, ["depth", "views_depth"], ref, work,
                        backend="gloo", device="cuda", timeout=600,
                        threads=4)
        t_rows = time.perf_counter()
        rows = E.spawn(2, ["spatial", "views_spatial", "engine_spatial"],
                       ref, work, backend="gloo", device="cuda",
                       timeout=600, threads=4)
        rows_s = time.perf_counter() - t_rows
        t_dsp = time.perf_counter()
        dsp = E.spawn(2, ["depth_spatial", "views_depth_spatial"], ref,
                      work, backend="gloo", device="cuda", timeout=600,
                      threads=4)
        dsp_s = time.perf_counter() - t_dsp
    for name, r in [*((n, report[n]) for n in ("data", "views")),
                    *((n, depth[n]) for n in ("depth", "views_depth")),
                    *((n, rows[n]) for n in ("spatial", "views_spatial")),
                    *((n, dsp[n]) for n in ("depth_spatial",
                                            "views_depth_spatial"))]:
        n = r["launches"]
        if not (n["k1"] == 3 and n["k2"] == 9 and n["k3"] == 3):
            raise AssertionError(f"distributed {name}: launches {n}")
        r.pop("grad_rel_l2")
    for name, r in (("engine", report["engine"]),
                    ("engine_spatial", rows["engine_spatial"])):
        if r["launches"]["k4"] != 8:
            raise AssertionError(f"distributed {name}: {r}")
    for e in rows_entries:
        e["launches"] = rows["spatial"]["launches"][
            "k1" if e["name"] == "warp_correlate" else "k3"]
    bounds = {"dloss": f"{E.LOSS_RTOL} (1 + |loss|)",
              "max_dparam": E.PARAM_ATOL, "grad_rel_l2": E.GRAD_REL}
    log({"phase": "distributed", "ranks": 2,
         "route": "gloo on CUDA tensors, both ranks on cuda:0",
         "step_config": "blend_finetune B8 V7 768x576 96/8/8 fp32",
         "engine_config": "dtu B6 V5 1152x864 48/8/8 fp32",
         "single_process_loss": ref["step"][0], **report,
         "bounds": bounds, "reference_seconds": ref_s,
         "seconds": time.perf_counter() - t0})
    D1 = BLEND["ndepths"][0]
    log({"phase": "distributed_depth", "ranks": 2,
         "route": "gloo on CUDA tensors, both ranks on cuda:0; halos, "
                  "gathers and BN sums as all_reduces of zero-padded blocks",
         "step_config": "blend_finetune B8 V7 768x576 96/8/8 fp32",
         "single_process_loss": ref["step"][0],
         "single_process_peak_gib": single_peak,
         "k1_stage1_route": {
             name: {"hypotheses": d, "window_plan": list(
                 cuda_warp.window_plan("fwd", CDIM[0], torch.float32, d))}
             for name, d in (("depth", D1 // 2), ("views_depth", D1))},
         "k1_depth_blocks": blocks, **depth, "bounds": bounds,
         "seconds": time.perf_counter() - t0})
    log({"phase": "distributed_spatial", "ranks": 2,
         "route": "gloo on CUDA tensors, both ranks on cuda:0; halos, "
                  "gathers and BN sums as all_reduces of zero-padded blocks",
         "step_config": "blend_finetune B8 V7 768x576 96/8/8 fp32, image "
                        "rows 288 + 288 (stage 1: 36 + 36)",
         "engine_config": "dtu B6 V5 1152x864 48/8/8 fp32, image rows "
                          "416 + 448 (stage 1: 52 + 56)",
         "single_process_loss": ref["step"][0],
         "single_process_peak_gib": single_peak,
         "single_process_memory": ref["memory"],
         "k1_k3_row_blocks": row_blocks, **rows, "bounds": bounds,
         "seconds": rows_s})
    log({"phase": "distributed_depth_spatial", "ranks": 2,
         "route": "gloo on CUDA tensors, both ranks on cuda:0; the 2-D "
                  "activations by image rows, the cost volumes by "
                  "hypotheses, each tensor along one axis",
         "step_config": "blend_finetune B8 V7 768x576 96/8/8 fp32, image "
                        "rows 288 + 288 (stage 1: 36 + 36), stage-1 "
                        "hypotheses 48 + 48, stages 2-3 4 + 4",
         "single_process_loss": ref["step"][0],
         "single_process_peak_gib": single_peak,
         "single_process_memory": ref["memory"],
         "peak_gib_depth": depth["depth"]["peak_gib"],
         "peak_gib_spatial": rows["spatial"]["peak_gib"],
         **dsp, "bounds": bounds, "seconds": dsp_s})
    return rows_entries, {n: dsp[n]["launches"] for n in (
        "depth_spatial", "views_depth_spatial")}


def row_block_kernels(torch):
    """K1 and K3 on the two row blocks of the fine-tune config's image
    (288 + 288 rows) at stage 1 (72x96, C=32, the expanded 96-hypothesis
    sweep: K1's windowed kernel) and stage 3 (288x384, C=8, 8 per-pixel
    hypotheses: K1's direct kernel), fp32 as the fine-tune step runs:
    each block's reference rows and depths against the whole source maps
    with the block's row offset, held against the plain version with the
    same offset (``check_kernel``) and timed; K1 also read against the
    whole image's kernel output on those rows (equal bit for bit: a ray
    is formed from the pixel's row in the whole image).  A block's bound
    counts the source texels its taps reach (``tapped_texels``), and K3's
    the write of the whole ``d_src``.  Returns (the readings, the
    kernel-line entries)."""
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.ops import cuda_warp
    from effi_mvs_plus_tpu_torch.parallel import row_blocks_of
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    proj_ms, dv = rig(BLEND, camio)
    readings, entries = [], []
    for s in (0, 2):
        ref, src, rots, trs, depth = stage_inputs(
            torch, geometry, BLEND, proj_ms, dv, s, torch.float32, gen)
        B, V, D = src.shape[0], src.shape[1], depth.shape[1]
        h, w, C = ref.shape[1], ref.shape[2], ref.shape[3]
        with torch.inference_mode():
            whole = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
        texels = B * V * h * w
        whole_share = tapped_texels(torch, geometry, rots, trs, depth, h,
                                    w) / texels
        k = BLEND["H"] // h
        for m, (a, b) in enumerate(row_blocks_of(BLEND["H"], 2)):
            y0, hb = a // k, (b - a) // k
            rb, db = ref[:, y0:y0 + hb], depth[:, :, y0:y0 + hb]
            what = f"blend stage{s + 1} rows {y0}-{y0 + hb - 1}"
            with torch.inference_mode():
                got = cuda_warp.warp_correlate_views(rb, src, rots, trs, db,
                                                     y0)
                err = check_kernel("warp_correlate", what, got,
                                   cuda_warp._views_torch(rb, src, rots, trs,
                                                          db, y0), "float32")
                diff = float((got - whole[:, :, :, y0:y0 + hb]).abs().max())
                n_out = B * V * D * hb * w
                tapped = tapped_texels(torch, geometry, rots, trs, db, h, w,
                                       y0)
                bms, bby = bound((rb.numel() + tapped * C + n_out) * 4
                                 + unique_bytes(db)
                                 + (rots.numel() + trs.numel()) * 4,
                                 n_out * (10 * C + 16), "float32")
                entries.append(dict(
                    name="warp_correlate", route="cuda",
                    source="effi_mvs_plus_tpu_torch/csrc/warp_correlate.cu",
                    replaces="effi_mvs_plus_tpu/ops/pallas_warp.py:427",
                    config="blend_rows", stage=s + 1, dtype="float32",
                    shape=f"B{B} V{V} D{D} rows {y0}+{hb} of {h}x{w} C{C}",
                    launches_per_forward=3, max_abs_err=err,
                    max_abs_diff_whole_image=diff,
                    src_texels_tapped=tapped / texels,
                    ms=median_ms(torch, lambda: cuda_warp.warp_correlate_views(
                        rb, src, rots, trs, db, y0), 21),
                    plain_ms=median_ms(torch, lambda: cuda_warp._views_torch(
                        rb, src, rots, trs, db, y0), 3),
                    bound_ms=bms, bound_by=bby, library_ms=None))
            g = torch.randn((B, V, D, hb, w), generator=gen, device="cuda")
            d_ref, d_src = cuda_warp._views_bwd_cuda(rb, src, rots, trs, db, g,
                                                     y0=y0)
            grad = plain_bwd(torch, cuda_warp, rb, src, rots, trs, db, y0)
            want = grad(g)
            scale = max(1.0, *(float(t.abs().max()) for t in want))
            err3 = max(check_kernel("warp_correlate_bwd", f"{what} {n}", a_,
                                    b_, "float32", scale)
                       for n, a_, b_ in zip(("d_ref", "d_src"),
                                            (d_ref, d_src), want))
            taps = valid_taps(torch, geometry, rots, trs, db, h, w, y0)
            bms3, bby3 = bound((2 * rb.numel() + tapped * C + src.numel()
                                + g.numel()) * 4
                               + unique_bytes(db)
                               + (rots.numel() + trs.numel()) * 4,
                               20 * g.numel() + 4 * C * taps, "float32")
            entries.append(dict(
                name="warp_correlate_bwd", route="cuda",
                source="effi_mvs_plus_tpu_torch/csrc/warp_correlate_bwd.cu",
                replaces="effi_mvs_plus_tpu/ops/pallas_warp.py:777",
                config="blend_rows", stage=s + 1, dtype="float32",
                shape=f"B{B} V{V} D{D} rows {y0}+{hb} of {h}x{w} C{C}",
                launches_per_forward=3, atomics=taps * C,
                src_texels_tapped=tapped / texels, max_abs_err=err3,
                tolerance=ATOL["warp_correlate_bwd"] * scale,
                ms=median_ms(torch, lambda: cuda_warp._views_bwd_cuda(
                    rb, src, rots, trs, db, g, y0=y0), 21),
                plain_ms=median_ms(torch, lambda: grad(g), 3),
                bound_ms=bms3, bound_by=bby3, library_ms=None))
            readings.append({"stage": s + 1, "rows": [y0, y0 + hb],
                             "src_texels_tapped": tapped / texels,
                             "whole_image_src_texels_tapped": whole_share,
                             "k1_max_abs_err": err,
                             "k1_max_abs_diff_whole_image": diff,
                             "k3_max_abs_err": err3})
            log({"phase": "kernels", **entries[-2]})
            log({"phase": "kernels", **entries[-1]})
            del g, d_ref, d_src, grad, want
        del ref, src, depth, whole
        torch.cuda.empty_cache()
    return readings, entries


def depth_block_k1(torch):
    """K1 on each of two D-blocks of the stage-1 sweep at the fine-tune
    config (B=8, 6 sources, 72x96, C=32, 96 hypotheses, fp32), each block
    a slice of the expanded (B,D,h,w) view as the depth layout hands it
    (an offset, stride 0 on h and w): held against the plain version on
    the same slice (``check_kernel``) and read against the whole sweep's
    kernel output there."""
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.ops import cuda_warp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    proj_ms, dv = rig(BLEND, camio)
    ref, src, rots, trs, depth = stage_inputs(
        torch, geometry, BLEND, proj_ms, dv, 0, torch.float32, gen)
    whole = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
    n = depth.shape[1] // 2
    out = []
    for m in range(2):
        blk = depth[:, m * n:(m + 1) * n]
        got = cuda_warp.warp_correlate_views(ref, src, rots, trs, blk)
        err = check_kernel("warp_correlate", f"blend stage1 D-block {m}",
                           got, cuda_warp._views_torch(ref, src, rots, trs,
                                                       blk), "float32")
        out.append({"hypotheses": [m * n, (m + 1) * n],
                    "depth_strides": list(blk.stride()),
                    "depth_offset": blk.storage_offset(),
                    "max_abs_err": err,
                    "max_abs_diff_whole_sweep": float(
                        (got - whole[:, :, m * n:(m + 1) * n]).abs().max())})
    return out


def write_dtu_tree(root):
    """A DTU-training tree at the training config, made from the seed
    (``CACHE_TREE``): 640x512 noise images, a distinct one for each view
    and light; raw depth and mask at twice the size plus a margin, as the
    reader half-scales and centre-crops them (the layout of
    ``tests/test_torch_cli_train.py``'s tree); the training rig's cameras.
    Returns the scan list file."""
    from PIL import Image
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.pfm import save_pfm
    V, H, W = CACHE_TREE["views"], TRAIN["H"], TRAIN["W"]
    rng = np.random.default_rng(SEED)
    os.makedirs(os.path.join(root, "Cameras", "train"))
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write(f"{V}\n")
        for v in range(V):
            srcs = sorted((s for s in range(V) if s != v),
                          key=lambda s: abs(s - v))[:10]
            f.write(f"{v}\n{len(srcs)} "
                    + " ".join(f"{s} {100.0 - abs(s - v)}" for s in srcs)
                    + "\n")
    intr_q = np.array([[TRAIN["f"], 0, W / 8], [0, TRAIN["f"], H / 8],
                       [0, 0, 1]], np.float32)
    for v in range(V):
        E = np.eye(4, dtype=np.float32)
        a = TRAIN["ang"] * (v - V // 2)
        c, s_ = np.cos(a), np.sin(a)
        E[:3, :3] = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
        E[:3, 3] = [st * (v - V // 2) for st in TRAIN["step"]]
        camio.write_cam_file(os.path.join(
            root, "Cameras", "train", f"{v:08d}_cam.txt"), E, intr_q,
            [TRAIN["dmin"], 2.5])
    scan = CACHE_TREE["scan"]
    img_dir = os.path.join(root, "Rectified", f"{scan}_train")
    dep_dir = os.path.join(root, "Depths_raw", scan)
    os.makedirs(img_dir)
    os.makedirs(dep_dir)
    m = CACHE_TREE["margin"]
    yy, xx = np.mgrid[0:2 * H + m, 0:2 * W + m]
    for v in range(V):
        for light in range(CACHE_TREE["lights"]):
            img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(
                img_dir, f"rect_{v + 1:03d}_{light}_r5000.png"),
                compress_level=1)
        d0, a, b = rng.uniform(550, 800), *rng.uniform(-0.05, 0.05, 2)
        save_pfm(os.path.join(dep_dir, f"depth_map_{v:04d}.pfm"),
                 np.clip(d0 + a * xx + b * yy, 430, 930).astype(np.float32))
        Image.fromarray(np.full((2 * H + m, 2 * W + m), 255, np.uint8)).save(
            os.path.join(dep_dir, f"depth_visual_{v:04d}.png"))
    listfile = os.path.join(root, "list.txt")
    with open(listfile, "w") as f:
        f.write(scan + "\n")
    return listfile


def float_ulps(torch, a, b):
    """|a - b| in units in the last place, elementwise (fp32, same sign)."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def device_cache_phase(torch, tree, listfile, write_s):
    """The device cache (``data/device_cache.py``) on the card at the DTU
    training config, on a tree ``write_dtu_tree`` made (12 views, 7
    lights, in ``write_s`` seconds).  Its test-mode batches are held to
    the ``Loader``'s after ``batch_to_device``: every leaf but the images
    bit for bit, the images in their bytes (x * 255 rounded) and within
    one fp32 ulp (the cache rounds x / 255 as the JAX cache, x times the
    reciprocal); the cache's batches pass through ``batch_to_device``
    without a copy.  Then
    ``cli/train.py main --mode train`` for an epoch (21 steps of B=4 and 3
    eval batches) fed by the cache and by the ``Loader`` in turns (cache,
    Loader, cache, Loader), each step timed by CUDA events and by the host
    clock from one step's end to the next's, with the launch counts of
    each run.  Returns the first cache-fed run's launch counts."""
    from effi_mvs_plus_tpu_torch.cli import train as cli
    from effi_mvs_plus_tpu_torch.data.datasets import DTUTrainDataset
    from effi_mvs_plus_tpu_torch.data.device_cache import DeviceCacheLoader
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.train import trainer as T
    B, V = TRAIN["B"], TRAIN["V"]
    dev = torch.device("cuda")
    t0 = time.perf_counter() - write_s

    # test-mode batches: the cache on the card against the Loader
    t1 = time.perf_counter()
    ds = DTUTrainDataset(tree, listfile, "test", V)
    cache = DeviceCacheLoader(ds, B, drop_last=True, device=dev)
    build_s = time.perf_counter() - t1
    loader = Loader(ds, B, drop_last=True, num_workers=8)
    if len(cache) != len(loader):
        raise AssertionError(f"cache {len(cache)} against Loader "
                             f"{len(loader)} batches")
    img_ulps, off = 0, 0
    for got, want in zip(cache, loader):
        want.pop("filename")
        want = T.batch_to_device(want, dev)
        for k in ("proj_matrices", "depth", "mask", "depth_values"):
            g, w = got[k], want[k]
            pairs = ([(g[j], w[j]) for j in sorted(w)]
                     if isinstance(w, dict) else [(g, w)])
            if (isinstance(w, dict) and sorted(g) != sorted(w)) or not all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in pairs):
                raise AssertionError(f"device cache: {k} differs from "
                                     f"the Loader's")
        gi, wi = got["imgs"], want["imgs"]
        ulps = float_ulps(torch, gi, wi)
        img_ulps = max(img_ulps, int(ulps.max()))
        off += int((ulps > 0).sum())
        if not (torch.equal(torch.round(gi * 255), torch.round(wi * 255))
                and img_ulps <= 1):
            raise AssertionError(f"device cache: images {img_ulps} ulps "
                                 f"from the Loader's")
        moved = T.batch_to_device(got, dev)
        if not (moved["imgs"] is gi
                and moved["depth"]["stage4"] is got["depth"]["stage4"]):
            raise AssertionError("batch_to_device copied a batch "
                                 "already on the card")
    n_px = len(cache) * gi.numel()
    test_bytes = cache.nbytes()
    del cache, got, want, moved, gi, wi
    torch.cuda.empty_cache()

    # training through the CLI, fed by the cache and by the Loader
    made = []
    real = cli.device_cache_loaders

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]
    steps, evals = (CACHE_TREE["views"] * CACHE_TREE["lights"] // B,
                    CACHE_TREE["views"] // B)
    want = {"k1_launches": 3 * (steps + evals),
            "k2_launches": 9 * (steps + evals), "k3_launches": 3 * steps,
            "k4_launches": 8 * evals, "conv3d_reg_launches": 25 * evals}
    runs = []
    cli.device_cache_loaders = recording
    try:
        for i, cached in enumerate((True, False, True, False)):
            argv = ["--mode", "train", "--device", "cuda", "--trainpath",
                    tree, "--trainlist", listfile, "--testlist",
                    listfile, "--logdir", os.path.join(tree, f"run{i}"),
                    "--epochs", "1", "--batch_size", str(B),
                    "--trainviews", str(V), "--testviews", str(V),
                    "--summary_freq", "7", "--num_workers", "8",
                    "--loadckpt", os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "checkpoints", "model_dtu.npz")]
            step_ms, done, n, secs = timed_cli(
                torch, argv + (["--device_cache"] if cached else []))
            if len(step_ms) != steps or n != want:
                raise AssertionError(f"device cache run {i}: "
                                     f"{len(step_ms)} steps, launches "
                                     f"{n} (want {want})")
            timed = step_ms[1:]          # the first step warms up
            wall = [(done[j] - done[j - 1]) * 1e3
                    for j in range(2, len(done))]
            runs.append({
                "fed_by": "device cache" if cached else "Loader",
                "samples_per_s": B / (statistics.median(timed) / 1e3),
                "wall_samples_per_s": B / (statistics.median(wall)
                                           / 1e3),
                "step_ms": timed, "wall_step_ms": wall, **n,
                "cli_seconds": secs})
    finally:
        cli.device_cache_loaders = real
    train_cache, eval_cache = made[0]
    out = {"phase": "device_cache",
           "config": "dtu train B4 V5 640x512 48/8/8 fp32",
           "tree": f"{CACHE_TREE['views']} views x "
                   f"{CACHE_TREE['lights']} lights, written from the "
                   f"seed",
           "write_seconds": write_s, "test_cache_build_seconds": build_s,
           "test_batches_vs_loader": {
               "batches": len(loader), "other_leaves": "bitwise",
               "img_bytes": "equal", "img_max_ulps": img_ulps,
               "img_share_one_ulp_off": off / n_px},
           "cache_bytes": {"train": train_cache.nbytes(),
                           "eval": eval_cache.nbytes(),
                           "test_mode_check": test_bytes},
           "runs": runs,
           "cache_samples_per_s": [r["samples_per_s"] for r in runs
                                   if r["fed_by"] != "Loader"],
           "loader_samples_per_s": [r["samples_per_s"] for r in runs
                                    if r["fed_by"] == "Loader"],
           "cache_wall_samples_per_s": [
               r["wall_samples_per_s"] for r in runs
               if r["fed_by"] != "Loader"],
           "loader_wall_samples_per_s": [
               r["wall_samples_per_s"] for r in runs
               if r["fed_by"] == "Loader"],
           "seconds": time.perf_counter() - t0}
    del made, train_cache, eval_cache
    torch.cuda.empty_cache()
    for r in out["runs"]:
        for k in ("step_ms", "wall_step_ms"):
            r[k] = [round(x, 3) for x in r[k]]
    log(out)
    return runs[0]


def jax_checkpoint_phase(torch, root, tree, listfile, sd):
    """A JAX training run carried onto the card, with every import of JAX,
    optax, orbax and flax refused while the phase runs (installed or
    not).  ``tests/jax_pickle.py`` writes the JAX train
    CLI's ``model_000000.ckpt`` pickle (the optax classes named as a real
    file names them): the shipped DTU weights in the JAX layouts, AdamW
    moments after an epoch of 21 seeded updates, both counts at 21.  Then
    ``cli/train.py main --resume`` on ``write_dtu_tree``'s tree at the DTU
    training config (640x512, 5 views, B=4, fp32) continues it at epoch 1
    for an epoch (21 steps, 3 eval batches), launch counts reset just
    before and read just after: the carried moments, steps and learning
    rate are read at the first resumed step, and that step's loss and
    gradients are held against the same step on the plain path
    (``compare_grads``).  Last, the carried weights serve through
    ``InferenceEngine(device="cuda")`` at the DTU eval config (K1, K2, K4),
    the 13 maps and the confidence held bitwise to the engine loaded from
    ``model_dtu.npz``, with a second npz-loaded forward to tell run-to-run
    variation apart.  Returns the launch counts of the resumed run and of
    the served forward."""
    import importlib.abc
    import importlib.util
    sys.path.insert(0, os.path.join(root, "tests"))
    import jax_pickle
    t0 = time.perf_counter()
    forbidden = ("jax", "jaxlib", "optax", "orbax", "flax")
    installed = [m for m in forbidden
                 if importlib.util.find_spec(m) is not None]

    class Refuse(importlib.abc.MetaPathFinder):
        """Fails an import of JAX or its libraries while the phase runs."""

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in forbidden:
                raise ModuleNotFoundError(f"{name}: refused in this phase")
            return None
    def loaded():
        return {m for m in sys.modules if m.split(".")[0] in forbidden}
    before = loaded()
    refuse = Refuse()
    sys.meta_path.insert(0, refuse)
    try:
        resumed, serve, out = _jax_checkpoint_run(torch, tree, listfile,
                                                  sd, jax_pickle)
    finally:
        sys.meta_path.remove(refuse)
    if loaded() - before:
        raise AssertionError(f"the phase imported {loaded() - before}")
    log({**out, "installed_here_imports_refused": installed,
         "imported_before_the_phase": sorted(before),
         "seconds": time.perf_counter() - t0})
    return resumed, serve


def _jax_checkpoint_run(torch, tree, listfile, sd, jax_pickle):
    """``jax_checkpoint_phase``'s work; returns the launch counts and the
    phase's log line."""
    from effi_mvs_plus_tpu_torch.cli import train as cli
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import (checkpoint_format,
                                            complete_state_dict,
                                            load_state_dict, torch_leaves)
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import onecycle_linear
    B = TRAIN["B"]
    steps = CACHE_TREE["views"] * CACHE_TREE["lights"] // B
    evals = CACHE_TREE["views"] // B
    logdir = os.path.join(tree, "jax_run")
    os.makedirs(logdir)
    path = os.path.join(logdir, "model_000000.ckpt")
    params = jax_pickle.jax_tree_from_state_dict(sd)
    mu, nu = jax_pickle.seeded_moments(params, steps, SEED)
    jax_pickle.write_jax_checkpoint(path, params, mu, nu, steps, steps, 0)
    weights = load_state_dict(path)
    if checkpoint_format(path) != "jax" or sorted(weights) != sorted(sd) \
            or not all(torch.equal(weights[k], v) for k, v in sd.items()
                       if not k.endswith("num_batches_tracked")):
        raise AssertionError("the JAX checkpoint's weights differ from the "
                             "npz's")
    want_mu = complete_state_dict(torch_leaves(mu))
    want_nu = complete_state_dict(torch_leaves(nu))

    # resume through the CLI; the first step's state and batch recorded
    argv = ["--mode", "train", "--device", "cuda", "--trainpath", tree,
            "--trainlist", listfile, "--testlist", listfile, "--logdir",
            logdir, "--epochs", "2", "--resume", "--batch_size", str(B),
            "--trainviews", str(TRAIN["V"]), "--testviews", str(TRAIN["V"]),
            "--summary_freq", "1", "--num_workers", "8"]
    sched = onecycle_linear(cli.build_parser().parse_args(argv).lr,
                            2 * steps + 100)
    first = {}
    real = T.make_train_step

    def recording(model, optimizer, scheduler, *args, **kwargs):
        step = real(model, optimizer, scheduler, *args, **kwargs)

        def run_step(batch):
            if not first:
                named = dict(model.named_parameters())
                st = [optimizer.state[p] for p in named.values()]
                first.update(
                    model=model,
                    saved={k: v.clone() for k, v in
                           model.state_dict().items()},
                    batch=T.batch_to_device(batch, "cuda"),
                    lr=optimizer.param_groups[0]["lr"],
                    last_epoch=scheduler.last_epoch,
                    adam_steps=sorted({float(x["step"]) for x in st}),
                    moments_bitwise=all(
                        torch.equal(x["exp_avg"].cpu(), want_mu[n])
                        and torch.equal(x["exp_avg_sq"].cpu(), want_nu[n])
                        for n, x in zip(named, st)))
            return step(batch)
        return run_step
    T.make_train_step = recording
    try:
        step_ms, _, resumed, cli_s = timed_cli(torch, argv)
    finally:
        T.make_train_step = real
    want = {"k1_launches": 3 * (steps + evals),
            "k2_launches": 9 * (steps + evals), "k3_launches": 3 * steps,
            "k4_launches": 8 * evals, "conv3d_reg_launches": 25 * evals}
    if len(step_ms) != steps or resumed != want:
        raise AssertionError(f"resumed run: {len(step_ms)} steps, launches "
                             f"{resumed} (want {want})")
    if not (first["moments_bitwise"] and first["adam_steps"] == [steps]
            and first["last_epoch"] == steps
            and abs(first["lr"] - sched(steps)) <= 1e-12):
        raise AssertionError(
            f"carried state at the first step: moments bitwise "
            f"{first['moments_bitwise']}, AdamW steps {first['adam_steps']}, "
            f"schedule {first['last_epoch']}, lr {first['lr']} (want "
            f"{steps}, {sched(steps)})")
    rows = [json.loads(ln) for ln in open(os.path.join(logdir,
                                                       "metrics.jsonl"))]
    train = [r for r in rows if "train/loss" in r]
    if [r["step"] for r in train] != list(range(steps + 1, 2 * steps + 1)) \
            or not np.isfinite([r["train/loss"] for r in train]).all() \
            or not any(r.get("event") == "resume" and r["epoch"] == 1
                       for r in rows):
        raise AssertionError(f"resumed run: metrics rows {rows[:3]}")
    after = T.load_checkpoint(os.path.join(logdir, "model_000001.ckpt"))
    if after["scheduler"]["last_epoch"] != 2 * steps or {
            float(x["step"]) for x in after["optimizer"]["state"].values()
    } != {2.0 * steps}:
        raise AssertionError("the port's checkpoint of epoch 1 does not "
                             "count both epochs' steps")
    loss_k, loss_p, worst, worst_leaf, p90 = kernels_against_plain(
        torch, first["model"], first["batch"], first["saved"])
    carried = {"lr": first["lr"], "adam_steps": first["adam_steps"],
               "schedule_step": first["last_epoch"],
               "moments": "bitwise the file's"}
    del first, after
    torch.cuda.empty_cache()

    # the carried weights served, against the npz-loaded engine
    batch = dtu_batch(camio)
    args = (torch.from_numpy(batch["imgs"]).cuda(),
            {k: torch.from_numpy(batch["proj_matrices"][k]).cuda()
             for k in ("stage1", "stage2", "stage3")},
            torch.from_numpy(batch["depth_values"]).cuda())

    def forward(state):
        eng = InferenceEngine(state, EffiMVSConfig(), device="cuda")
        with torch.inference_mode():
            out = eng.model(*args)
        return [d.cpu() for d in out["depth"]] + [
            out["photometric_confidence"].cpu()]
    reset_launches()
    served = forward(weights)
    serve = launch_counts()
    if (serve["k1_launches"], serve["k2_launches"], serve["k4_launches"],
            serve["conv3d_reg_launches"]) != (3, 9, 8, 25):
        raise AssertionError(f"served forward: launches {serve}")
    npz = [forward(sd) for _ in range(2)]
    bitwise = all(torch.equal(a, b) for a, b in zip(served, npz[0]))
    rerun_bitwise = all(torch.equal(a, b) for a, b in zip(*npz))
    diff = max(float((a - b).abs().max()) for a, b in zip(served, npz[0]))
    if len(served) != 14 or not all(torch.isfinite(a).all()
                                    for a in served):
        raise AssertionError("served maps: not 13 finite maps and a "
                             "confidence")
    if not bitwise:
        if rerun_bitwise:
            raise AssertionError(f"the carried weights serve other maps "
                                 f"than the npz's (max abs {diff})")
        check_depth_maps("carried weights", {"depth": served[:13]},
                         {"depth": npz[0][:13]}, 0.5)
    return resumed, serve, {
         "phase": "jax_checkpoint",
         "checkpoint": "tests/jax_pickle.py: model_dtu.npz in the JAX "
                       "layouts, 21 seeded AdamW updates, epoch 0",
         "resume_config": "dtu train B4 V5 640x512 48/8/8 fp32",
         "resumed_steps": len(step_ms), "eval_batches": evals,
         "first_step": carried,
         "loss_kernels": loss_k, "loss_plain": loss_p,
         "grad_worst_rel_l2": worst, "grad_worst_leaf": worst_leaf,
         "grad_p90_rel_l2": p90,
         "samples_per_s": B / (statistics.median(step_ms[1:]) / 1e3),
         "cli_seconds": cli_s, **resumed,
         "serve_config": "dtu B6 V5 1152x864 48/8/8 fp32",
         "serve_launches": serve, "served_vs_npz_bitwise": bitwise,
         "npz_rerun_bitwise": rerun_bitwise, "served_vs_npz_max_abs": diff}


def entry_phase(torch):
    """The compile-check entry (``effi_mvs_plus_tpu_torch/entry.py``) on the
    card: ``entry()``'s forward (seeded weights, 1x3x64x96) against the
    same entry on the CPU within the fp32 map tolerance, and
    ``dryrun_multichip(2)``, the gate of ``views,depth`` and ``spatial``
    in two ranks (gloo on the one card) at the JAX bounds."""
    from effi_mvs_plus_tpu_torch import entry
    t0 = time.perf_counter()
    fn, args = entry.entry()
    got = fn(*args).cpu()
    fn_c, args_c = entry.entry(device="cpu")
    want = fn_c(*args_c)
    tol = 0.005 * float(want.max() - want.min()) + 0.5
    err = float((got - want).abs().max())
    if not (tuple(got.shape) == (1, 64, 96) and err < tol):
        raise AssertionError(f"entry: shape {tuple(got.shape)}, card "
                             f"against CPU {err} (tolerance {tol})")
    report = entry.dryrun_multichip(2)
    log({"phase": "entry", "shape": list(got.shape),
         "card_vs_cpu_depth_abs": err, "tolerance": tol,
         "dryrun": {k: {a: report[k][a] for a in (
             "dloss", "max_dparam", "grad_worst_rel_l2", "grad_worst_leaf",
             "grad_worst_ref_norm", "grad_median_ref_norm", "launches")}
             for k in ("views,depth", "spatial")},
         "seconds": time.perf_counter() - t0})


def gru_module(sd, stage, hd):
    """The checkpoint's ConvGRU of one stage, on the card."""
    from effi_mvs_plus_tpu_torch.models.blocks import ConvGRU
    pre = f"update_block_depth{stage}.depth_gru."
    gru = ConvGRU(hd, hd)
    gru.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                         if k.startswith(pre)}, strict=True)
    return gru.cuda()


if __name__ == "__main__":
    sys.exit(main())
