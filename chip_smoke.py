#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU, serving and
training.

    python3 chip_smoke.py

Needs one CUDA GPU (the kernels are built for sm_90a, an H100) and nvcc;
imports nothing of JAX.  It

1. prints the card's name and power limit (nvidia-smi) and builds the
   kernels from ``effi_mvs_plus_tpu_torch/csrc`` with nvcc;
2. runs K1 (warp + correlate) and K2 (ConvGRU step) at every stage shape
   of the DTU eval config (B=6, 5 views, 1152x864, 48/8/8), of the T&T
   config (B=1, 11 views, 1920x1056, 96/8/8) and of the DTU training
   config (B=4, 5 views, 640x512, 48/8/8), and K3 (the warp's backward)
   at every stage shape of the DTU training and eval configs, in fp32 and
   bf16,
   and holds each against its plain PyTorch version on the same inputs
   (K3: autograd of the plain warp), with the kernel and plain times from
   CUDA events; K1 and K3 also on a rig that projects off the image and
   one that sees hypotheses from behind;
3. drives the serving path: ``InferenceEngine(device="cuda")`` with the
   shipped DTU weights at the DTU eval config answers fp32 and bf16
   requests and writes a scene with ``save_scene_depths``, with the
   kernels' launch counts reset just before and read just after; one fp32
   request's 13 depth maps and confidence are held against the same
   forward with the plain versions in place of the kernels;
4. drives the training path: ``train/trainer.py``'s step at the DTU
   training config, fp32, from ``checkpoints/model_dtu.npz``, on seeded
   noise images and plane ground truth through the port's ``Loader``.
   One step's loss and gradients are held against the same step with the
   plain versions, and the step with the kernels is run twice to show the
   run-to-run spread; then timed steps, each launching 3 K1, 3 K3 and 9
   K2, with samples/s and peak memory;
5. prints a ``{"kernels": [...]}`` line, then the device line last.

Any failure raises and the exit code is nonzero.  Without a GPU it exits
1 and prints no result.
"""

import contextlib
import json
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
# elementwise (see check_kernel)
ATOL = {"warp_correlate": 1e-3, "conv_gru": 1e-4, "warp_correlate_bwd": 1e-3}
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
ND = 384                      # inverse-depth samples per batch item
HDIM = (48, 32, 16)
CDIM = (32, 16, 8)            # feature channels per stage
RATIO = (4.0, 2.0, 1.0)       # depth_intervals_ratio


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


@contextlib.contextmanager
def plain_kernels(cuda_warp, cuda_gru):
    """Route the model's two kernel calls to their plain versions (for the
    full-forward comparison only)."""
    saved = cuda_warp.warp_correlate_views, cuda_gru.gru_step

    def warp_plain(ref, src, rots, trs, depth):
        return cuda_warp._views_torch(ref, src, rots, trs, depth).to(ref.dtype)

    def gru_plain(h, x, p):
        return cuda_gru._gru_torch(h, x, p.convz.weight, p.convr.weight,
                                   p.convq.weight, p.convz.bias,
                                   p.convr.bias, p.convq.bias)
    cuda_warp.warp_correlate_views, cuda_gru.gru_step = warp_plain, gru_plain
    try:
        yield
    finally:
        cuda_warp.warp_correlate_views, cuda_gru.gru_step = saved


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
    resolve_device("cuda")          # true fp32: TF32 off for cuDNN, matmul
    log({"phase": "device", "nvidia_smi": card,
         "name": torch.cuda.get_device_name(0),
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 1. build ----
    t0 = time.perf_counter()
    _, build_s = _kernels.build(verbose=True)
    _kernels.library()
    log({"phase": "build", "nvcc_seconds": round(build_s, 2),
         "total_seconds": round(time.perf_counter() - t0, 2)})

    sd = load_npz_checkpoint(os.path.join(root, "checkpoints",
                                          "model_dtu.npz"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    # ---- 2. kernel phases ----
    with torch.inference_mode():
        entries = forward_kernel_phases(torch, sd, gen)
    entries += bwd_kernel_phases(torch, gen)
    torch.cuda.empty_cache()

    # ---- 3. serving path ----
    with torch.inference_mode():
        k1_main, k2_main = serving_path(torch, sd)
    torch.cuda.empty_cache()

    # ---- 4. training path ----
    train = training_path(torch, sd)

    for e in entries:
        if e["name"] == "warp_correlate_bwd":
            e["launches"] = train["k3_launches"]
        else:
            e["launches"] = k1_main if e["name"] == "warp_correlate" \
                else k2_main
            e["launches_train"] = train["k1_launches" if e["name"]
                                        == "warp_correlate" else
                                        "k2_launches"]
    print(json.dumps({"kernels": entries}), flush=True)
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
    from effi_mvs_plus_tpu_torch.ops import cuda_gru, cuda_warp

    entries = []
    for cname, cfg in (*CONFIGS.items(), ("train", TRAIN)):
        proj_ms, dv = rig(cfg, camio)
        for s in range(3):
            for dname, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16)):
                ref, src, rots, trs, depth = stage_inputs(
                    torch, geometry, cfg, proj_ms, dv, s, dtype, gen)
                B, V, D = src.shape[0], src.shape[1], depth.shape[1]
                h, w, C = ref.shape[1], ref.shape[2], ref.shape[3]

                def k1():
                    return cuda_warp.warp_correlate_views(ref, src, rots,
                                                          trs, depth)

                def p1():
                    return cuda_warp._views_torch(ref.float(), src.float(),
                                                  rots, trs, depth)
                err = check_kernel("warp_correlate",
                                   f"{cname} stage{s + 1} {dname}",
                                   k1(), p1(), dname)
                esz = ref.element_size()
                n_out = B * V * D * h * w
                byts = (ref.numel() + src.numel() + n_out) * esz \
                    + unique_bytes(depth) + (rots.numel() + trs.numel()) * 4
                bms, bby = bound(byts, n_out * (10 * C + 16), dname)
                entries.append(dict(
                    name="warp_correlate", route="cuda",
                    source="effi_mvs_plus_tpu_torch/csrc/warp_correlate.cu",
                    replaces="effi_mvs_plus_tpu/ops/pallas_warp.py:427",
                    config=cname, stage=s + 1, dtype=dname,
                    shape=f"B{B} V{V} D{D} {h}x{w} C{C}",
                    launches_per_forward=3, max_abs_err=err,
                    ms=median_ms(torch, k1, 7),
                    plain_ms=median_ms(torch, p1, 3),
                    bound_ms=bms, bound_by=bby, library_ms=None))
                del ref, src, depth

                hd = HDIM[s]
                gru = gru_module(sd, s + 1, hd)
                hx = torch.randn((2, B, h, w, hd), generator=gen,
                                 device="cuda")
                hh = torch.tanh(hx[0]).to(dtype).contiguous()
                xx = torch.relu(hx[1]).to(dtype).contiguous()
                del hx
                # the kernel rounds the weights to the inputs' dtype
                wk = [getattr(gru, g).weight.to(dtype).float()
                      for g in ("convz", "convr", "convq")]
                bk = [getattr(gru, g).bias for g in ("convz", "convr", "convq")]

                def k2():
                    return cuda_gru.gru_step(hh, xx, gru)

                def p2():
                    return cuda_gru._gru_torch(hh.float(), xx.float(), *wk,
                                               *bk)
                err = check_kernel("conv_gru",
                                   f"{cname} stage{s + 1} {dname}",
                                   k2(), p2(), dname)
                npx = B * h * w
                esz = hh.element_size()
                byts = 3 * npx * hd * esz + (9 * 2 * hd * 3 * hd + 3 * hd) * 4
                bms, bby = bound(byts, 108 * hd * hd * npx, dname)
                entries.append(dict(
                    name="conv_gru", route="cuda",
                    source="effi_mvs_plus_tpu_torch/csrc/conv_gru.cu",
                    replaces="effi_mvs_plus_tpu/ops/pallas_gru.py:104",
                    config=cname, stage=s + 1, dtype=dname,
                    shape=f"B{B} {h}x{w} hd{hd}",
                    launches_per_forward=9, max_abs_err=err,
                    ms=median_ms(torch, k2, 7),
                    plain_ms=median_ms(torch, p2, 3),
                    bound_ms=bms, bound_by=bby, library_ms=None))
                log({"phase": "kernels", **entries[-2]})
                log({"phase": "kernels", **entries[-1]})
                del hh, xx
        torch.cuda.empty_cache()

    # K1 on rigs that leave the image and that see hypotheses from behind
    cfg = CONFIGS["dtu"]
    proj_ms, dv = rig(cfg, camio)
    ref, src, rots, trs, depth = stage_inputs(
        torch, geometry, cfg, proj_ms, dv, 1, torch.float32, gen)
    h, w = ref.shape[1], ref.shape[2]
    # off_image: trans is in pixels x depth, so this shifts the projections
    # by 40% / 20% of the map at a mid-range depth.  behind: the negated
    # camera sees every hypothesis at z < 0 and projects each ref pixel to
    # the same place (grid_sample semantics cull nothing behind a camera),
    # so it must reproduce the ordinary rig's correlations exactly.
    wild = {"off_image": (rots, trs + torch.tensor(
                [0.4 * w * 680.0, 0.2 * h * 680.0, 0.0], device="cuda")),
            "behind": (-rots, -trs)}
    ordinary = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
    for rname, (r_, t_) in wild.items():
        got = cuda_warp.warp_correlate_views(ref, src, r_, t_, depth)
        err = check_kernel("warp_correlate", rname, got,
                           cuda_warp._views_torch(ref, src, r_, t_, depth),
                           "float32")
        zero = float((got == 0).float().mean())
        if rname == "off_image" and not 0.05 < zero < 0.95:
            raise AssertionError(f"K1 off_image: zero share {zero}")
        if rname == "behind" and not torch.equal(got, ordinary):
            raise AssertionError("K1 behind: differs from the ordinary rig")
        log({"phase": "kernel_rig", "rig": rname, "max_abs_err": err,
             "zero_share": zero})
    del ref, src, depth
    torch.cuda.empty_cache()
    return entries


def serving_path(torch, sd):
    """The engine at the DTU eval config, fp32 and bf16; returns the K1
    and K2 launch counts of the run."""
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.pfm import read_pfm
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    from effi_mvs_plus_tpu_torch.ops import cuda_gru, cuda_warp

    cfg = CONFIGS["dtu"]
    B = cfg["B"]
    proj_ms, dv = rig(cfg, camio)
    rng = np.random.default_rng(SEED)
    imgs = rng.uniform(0, 1, (B, cfg["V"], cfg["H"], cfg["W"], 3)).astype(
        np.float32)
    batch = {"imgs": imgs, "proj_matrices": proj_ms, "depth_values": dv,
             "filename": [f"scan1/{{}}/{b:08d}{{}}" for b in range(B)]}
    eng32 = InferenceEngine(sd, EffiMVSConfig(), device="cuda")
    eng16 = InferenceEngine(sd, EffiMVSConfig(compute_dtype=torch.bfloat16),
                            device="cuda")

    def request_ms(eng):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        depth, conf = eng._infer_device(batch)
        end.record()
        end.synchronize()
        return start.elapsed_time(end), depth, conf

    cuda_warp.launches = 0
    cuda_gru.launches = 0
    forwards = 0
    t32 = []
    for i in range(4):
        ms, d32, c32 = request_ms(eng32)
        forwards += 1
        if (cuda_warp.launches, cuda_gru.launches) != (3 * forwards,
                                                       9 * forwards):
            raise AssertionError(
                f"after {forwards} forwards: K1 {cuda_warp.launches}, "
                f"K2 {cuda_gru.launches} launches (want 3 and 9 each)")
        if i:
            t32.append(ms)
    t16 = []
    for i in range(3):
        ms, d16, c16 = request_ms(eng16)
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
    k1_main, k2_main = cuda_warp.launches, cuda_gru.launches
    if (k1_main, k2_main) != (3 * forwards, 9 * forwards) or not k1_main:
        raise AssertionError(f"main path: {forwards} forwards, K1 "
                             f"{k1_main}, K2 {k2_main} launches")

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
        n1, n2 = cuda_warp.launches, cuda_gru.launches
        with plain_kernels(cuda_warp, cuda_gru):
            out_p = model(*args)
        if (cuda_warp.launches, cuda_gru.launches) != (n1, n2):
            raise AssertionError("the plain forward launched a kernel")
    worst = 0.0
    for i, (g, want) in enumerate(zip(out_k["depth"], out_p["depth"])):
        scale = float(want.max() - want.min()) + 1e-6
        err = float((g - want).abs().max())
        worst = max(worst, err)
        if not err < 0.005 * scale + 0.5:
            raise AssertionError(f"depth {i}: kernel vs plain {err:.4f} "
                                 f"(range {scale:.1f})")
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
    return k1_main, k2_main


def plain_bwd(torch, cuda_warp, ref, src, rots, trs, depth):
    """The plain backward: autograd of the plain warp, in fp32 on the same
    values.  Returns grad(g) -> (d_ref, d_src), graph kept for reruns."""
    r = ref.float().requires_grad_()
    s = src.float().requires_grad_()
    out = cuda_warp._views_torch(r, s, rots, trs, depth)
    return lambda g: torch.autograd.grad(out, (r, s), g.float(),
                                         retain_graph=True)


def valid_taps(torch, geometry, rots, trs, depth, h, w):
    """In-image bilinear taps of the warp over all views and hypotheses:
    K3 reads, accumulates and scatters C channels for each."""
    n = 0
    for v in range(rots.shape[1]):
        px, py = geometry.project_to_src(rots[:, v], trs[:, v], depth, h, w)
        x0, y0 = torch.floor(px), torch.floor(py)
        inx = [(x0 + o >= 0) & (x0 + o < w) for o in (0, 1)]
        iny = [(y0 + o >= 0) & (y0 + o < h) for o in (0, 1)]
        n += sum(int((a & b).sum()) for a in inx for b in iny)
    return n


def bwd_kernel_phases(torch, gen):
    """K3 against the plain backward at the DTU training and eval stage
    shapes, fp32 and bf16, with the run-to-run difference of two launches
    (d_src's fp32 atomics add in no fixed order); then on the off-image
    and behind-the-camera rigs."""
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.ops import cuda_warp

    def check(what, ref, src, rots, trs, depth, g, dname):
        got = cuda_warp._views_bwd_cuda(ref, src, rots, trs, depth, g)
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
    for cname, cfg in (("train", TRAIN), ("dtu", CONFIGS["dtu"])):
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
                _, err, scale, rerun = check(what, ref, src, rots, trs,
                                             depth, g, dname)
                taps = valid_taps(torch, geometry, rots, trs, depth, h, w)
                esz = ref.element_size()
                byts = (2 * (ref.numel() + src.numel()) + g.numel()) * esz \
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
                    max_abs_err=err, tolerance=ATOL["warp_correlate_bwd"]
                    * scale, run_to_run_max_abs=rerun,
                    ms=median_ms(torch, lambda: cuda_warp._views_bwd_cuda(
                        ref, src, rots, trs, depth, g), 7),
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
    from effi_mvs_plus_tpu_torch import nn
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from effi_mvs_plus_tpu_torch.ops import cuda_gru, cuda_warp
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss
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
        return (cuda_warp.launches, cuda_warp.bwd_launches,
                cuda_gru.launches)

    # one step's loss and gradients, kernels against plain versions, from
    # the same weights, batch and dropout seed
    first = T.batch_to_device(next(batches), dev)
    saved = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads():
        model.load_state_dict(saved)      # a train forward moves BN stats
        model.zero_grad(set_to_none=True)
        model.train()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        nn.use_generator(model, gen)
        out = model(first["imgs"], first["proj_matrices"],
                    first["depth_values"])
        loss, _ = mvs_loss(out["depth"], first["depth"], first["mask"])
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    cuda_warp.launches = cuda_warp.bwd_launches = cuda_gru.launches = 0
    loss_k, grads_k = loss_and_grads()
    if counts() != (3, 3, 9):
        raise AssertionError(f"one step launched K1, K3, K2 {counts()} "
                             f"times, not 3, 3, 9")
    with plain_kernels(cuda_warp, cuda_gru):
        loss_p, grads_p = loss_and_grads()
    if counts() != (3, 3, 9):
        raise AssertionError("the plain step launched a kernel")
    worst, worst_leaf, p90 = compare_grads(loss_k, grads_k, loss_p, grads_p)
    # the same step with the kernels again: K3's and the convolutions'
    # backward add in no fixed order, so this is the run-to-run spread
    loss_k2, grads_k2 = loss_and_grads()
    rerun, rerun_leaf, rerun_p90 = compare_grads(loss_k2, grads_k2, loss_k,
                                                 grads_k)
    del grads_k, grads_p, grads_k2, first
    model.load_state_dict(saved)
    model.zero_grad(set_to_none=True)

    # the timed run: launch counts reset just before, read just after
    opt, scheduler, _ = make_optimizer(model, 1e-3, 1000)
    step = T.make_train_step(model, opt, scheduler, seed=SEED, device=dev)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith("running_mean")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    cuda_warp.launches = cuda_warp.bwd_launches = cuda_gru.launches = 0
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
        if counts() != (3 * (i + 1), 3 * (i + 1), 9 * (i + 1)):
            raise AssertionError(f"after {i + 1} steps: K1, K3, K2 "
                                 f"launched {counts()} times")
    batches.close()
    k1, k3, k2 = counts()
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
         "k2_launches": k2,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return {"k1_launches": k1, "k2_launches": k2, "k3_launches": k3}


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
