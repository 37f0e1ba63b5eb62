"""The ConvGRU step K2 and the stem chain K4 alone on the card, through
``chip_smoke.py``'s own phases: build the kernels (printing nvcc's register
and shared-memory report), then hold K2 at every stage shape of the DTU
eval, T&T and DTU training configs, and K4 at every stem chain of both
FPNs at the T&T and DTU configs, against their plain versions with
chip_smoke.py's checks, fp32 and bf16, one JSON line a case (``ms`` on
weights packed once, ``pack_ms`` packing at each call, as chip_smoke.py
prints them).

    python scripts/torch_probe_k2k4.py [--only k2|k4]

Needs a CUDA GPU and nvcc; about a minute where chip_smoke.py takes three.
Its inputs come from a fresh generator, so they are not the ones
chip_smoke.py draws after its K1 and K3 phases.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from effi_mvs_plus_tpu_torch.device import resolve_device  # noqa: E402
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint  # noqa: E402
from effi_mvs_plus_tpu_torch.ops import _kernels  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("k2", "k4"))
    args = ap.parse_args()
    resolve_device("cuda")
    _kernels.build(verbose=True)
    _kernels.library()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    with torch.inference_mode():
        if args.only != "k4":
            sd = load_npz_checkpoint(os.path.join(ROOT, "checkpoints",
                                                  "model_dtu.npz"))
            for cname, cfg in (*chip_smoke.CONFIGS.items(),
                               ("train", chip_smoke.TRAIN)):
                for s in range(3):
                    bhw = (cfg["B"], cfg["H"] >> (3 - s), cfg["W"] >> (3 - s))
                    for dtype in (torch.float32, torch.bfloat16):
                        chip_smoke.log(chip_smoke.gru_entry(
                            torch, sd, gen, cname, bhw, s,
                            str(dtype).split(".")[1], dtype))
                torch.cuda.empty_cache()
        if args.only != "k2":
            chip_smoke.conv_chain_phases(torch, ROOT, gen)


if __name__ == "__main__":
    main()
