#!/usr/bin/env python3
"""Where a DTU training step's device time goes in the PyTorch/CUDA port.

    python3 scripts/torch_profile_train.py [--steps 3] [--out FILE]

Needs one CUDA GPU and nvcc; imports nothing of JAX.  Builds the port's
model from ``checkpoints/model_dtu.npz`` and ``train/trainer.py``'s step
at the DTU training config of ``chip_smoke.py`` (B=4, 5 views, 640x512,
48/8/8, fp32, the same seeded noise images and plane ground truth through
the port's ``Loader``), runs two warm-up steps, then traces ``--steps``
steps with ``torch.profiler``.  Prints one JSON line: step time, the
device time by kernel class (K1 warp + correlate, K3 its backward, K2
ConvGRU, convolutions, other kernels, memory copies), the top kernels by
device time, the device's idle share of the traced window and the peak
device memory.  ``--out`` also writes the line to a file.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402  (the training config and its data)
from torch_profile_dtu import busy_union_us, classify  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    B = chip_smoke.TRAIN["B"]
    loader = Loader(chip_smoke.SyntheticDTU(B * (2 + args.steps), camio), B,
                    num_workers=4)
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(load_npz_checkpoint(
        os.path.join(ROOT, "checkpoints", "model_dtu.npz")), strict=True)
    model.cuda()
    opt, scheduler, _ = make_optimizer(model, 1e-3, 1000)
    step = T.make_train_step(model, opt, scheduler, seed=chip_smoke.SEED,
                             device="cuda")
    batches = iter(loader)
    for _ in range(2):
        step(next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(next(batches))
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
    n = args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    line = {
        "config": "dtu train B4 V5 640x512 48/8/8 fp32", "card": card,
        "steps": n, "wall_ms_per_step": wall_us / n / 1e3,
        "samples_per_s": B * n / (wall_us / 1e6),
        "device_ms_per_step": device / n / 1e3,
        "busy_ms_per_step": busy / n / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "ms_per_step_by_class": {k: v / n / 1e3
                                 for k, v in sorted(by_class.items())},
        "share_by_class": {k: v / device for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_step": [[k[:120], v / n / 1e3] for k, v in top],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
