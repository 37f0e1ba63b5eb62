#!/usr/bin/env python3
"""Where a DTU eval request's device time goes in the PyTorch/CUDA port.

    python3 scripts/torch_profile_dtu.py [--requests 3] [--out FILE]

Needs one CUDA GPU and nvcc; imports nothing of JAX.  Builds the port's
``InferenceEngine`` with ``checkpoints/model_dtu.npz`` at the DTU eval
config of ``chip_smoke.py`` (B=6, 5 views, 1152x864, 48/8/8, the same
seeded rig and noise images), and for fp32 and bf16 in turn runs two
warm-up requests, then traces ``--requests`` requests with
``torch.profiler``.  Prints one JSON line per precision: the device time
by kernel class (K1 warp + correlate, K2 ConvGRU, K4 stem chain,
convolutions, other kernels, memory copies), the top kernels by device
time, and the device's idle share of the traced window (wall time between
the synchronised start and end, less the union of the device's busy
intervals).  ``--out`` also
writes the lines to a file.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the DTU rig and config)

# kernel-name markers of each class, tested in this order
CLASSES = (
    ("k3_warp_correlate_bwd", ("warp_correlate_bwd_kernel",
                               "dref_sum_kernel")),
    ("k1_warp_correlate", ("warp_correlate_kernel",
                           "warp_correlate_direct_kernel")),
    ("k2_conv_gru", ("conv_gru_kernel",)),
    ("k4_conv_chain", ("conv_chain_kernel",)),
    ("memcpy_memset", ("Memcpy", "Memset")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm",
                     "winograd", "fprop", "cutlass", "sm90_", "sm80_")),
)


def classify(name):
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def busy_union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(torch, eng, batch, n_requests):
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(2):
        eng._infer_device(batch)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_requests):
            eng._infer_device(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_class, by_name, spans = {}, {}, []
    for e in kernels:
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        by_class[classify(e.name)] = by_class.get(classify(e.name), 0.0) \
            + (t - s)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    busy = busy_union_us(spans)
    device = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "requests": n_requests, "maps": n_requests * batch["imgs"].shape[0],
        "wall_ms_per_request": wall_us / n_requests / 1e3,
        "device_ms_per_request": device / n_requests / 1e3,
        "busy_ms_per_request": busy / n_requests / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "ms_per_request_by_class": {k: v / n_requests / 1e3
                                    for k, v in sorted(by_class.items())},
        "share_by_class": {k: v / device for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_request": [[n[:120], v / n_requests / 1e3]
                                       for n, v in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_dtu: no CUDA device", file=sys.stderr)
        return 1
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = chip_smoke.CONFIGS["dtu"]
    proj_ms, dv = chip_smoke.rig(cfg, camio)
    rng = np.random.default_rng(chip_smoke.SEED)
    imgs = rng.uniform(0, 1, (cfg["B"], cfg["V"], cfg["H"], cfg["W"], 3)
                       ).astype(np.float32)
    batch = {"imgs": imgs, "proj_matrices": proj_ms, "depth_values": dv}
    sd = load_npz_checkpoint(os.path.join(ROOT, "checkpoints",
                                          "model_dtu.npz"))
    lines = []
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        eng = InferenceEngine(sd, EffiMVSConfig(compute_dtype=dt),
                              device="cuda")
        with torch.inference_mode():
            res = profile(torch, eng, batch, args.requests)
        lines.append({"config": "dtu B6 V5 1152x864 48/8/8",
                      "dtype": name, "card": card, **res})
        print(json.dumps(lines[-1]), flush=True)
        del eng
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
