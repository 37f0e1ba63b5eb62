"""Where two fp32 summation orders of K2's and K4's bf16 arithmetic
disagree, and whether both stay within the range the card's checks
accept (``ops/rounding_bounds.py``).

    python scripts/torch_probe_rounding.py [--device cpu|cuda] [--views N]

The TPU kernels round intermediates to bf16: r*h before the GRU's q
convolution (``pallas_gru.py:149``), each layer's output of the stem chain
(``pallas_conv.py``); so do the port's kernels and their plain versions.
Two implementations that sum the same products in another order round a
value within fp32 noise of a bf16 boundary apart, and the outputs it
reaches move by one bf16 ulp of it times a weight.  This script computes
the same arithmetic twice on the same seeded bf16 inputs, once with fp32
convolutions and once with float64 ones rounded to fp32 (another order,
nearer the exact sum):

* K2 at the three DTU stage shapes, B=2, with the DTU checkpoint's GRU
  weights and chip_smoke.py's inputs (h = tanh, x = relu of N(0, 1));
* K4 at the feature net's four stem chains of ``model_tank.npz`` (folded
  BN) on the inputs an inference forward hands them (seeded uniform
  images, N views at 1920x1056, default 2).

It prints one JSON line a case: how many outputs the two orders put
beyond the plain tolerance of each other (K2: 1e-4 + 2^-8 |ref|; K4:
(5e-5 + L 2^-8) max(|ref|, 1)), how many lie outside that tolerance of
the range [lo, hi] (the checks require none), how many rounded values
have two admissible roundings, the share of outputs whose range is
wider than the tolerance, and the largest error of an fp32 convolution
sum (K2: the r gate's; K4: each layer's) against float64 in units of
2^-24 times the sum of its terms' magnitudes, the scale of the range's
tau (``rounding_bounds.NOISE`` such units).
"""

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint  # noqa: E402
from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model  # noqa: E402
from effi_mvs_plus_tpu_torch.ops import cuda_conv, rounding_bounds  # noqa: E402

GRU_STAGES = ((1, 48, 108, 144), (2, 32, 216, 288), (3, 16, 432, 576))


def conv(x, w, b, acc):
    """3x3 pad-1 convolution of x (B,H,W,C) summed in `acc`, in fp32."""
    y = F.conv2d(x.movedim(-1, 1).to(acc), w.to(acc), None, padding=1)
    return y.movedim(1, -1).float() + b.float()


def gru(h, x, wz, wr, wq, bz, br, bq, acc):
    """``_gru_reference(rounded=False)``'s arithmetic, summed in `acc`."""
    hf, xf = h.float(), x.float()
    hd = h.shape[-1]
    w = [t.to(h.dtype).float() for t in (wz, wr, wq)]
    zr = torch.sigmoid(conv(torch.cat([hf, xf], -1), torch.cat(w[:2]),
                            torch.cat([bz, br]), acc))
    z, r = zr[..., :hd], zr[..., hd:]
    rh = (r * hf).to(h.dtype).float()
    q = torch.tanh(conv(torch.cat([rh, xf], -1), w[2], bq, acc))
    return hf + z * (q - hf)


def chain(x, specs, acc):
    """``_chain_torch``'s arithmetic, summed in `acc`."""
    y = x
    for w, b in specs:
        y = torch.relu(conv(y.float(), w.to(x.dtype).float(), b,
                            acc)).to(x.dtype)
    return y


def noise_units(x, w, b):
    """max |fp32 sum - float64 sum| / (2^-24 sum |terms|) of a 3x3
    convolution of x (B,H,W,C) with w, b."""
    x64, w64, b64 = x.double(), w.double(), b.double()
    err = (conv(x.float(), w.float(), b, torch.float32).double()
           - conv(x64, w64, b64, torch.float64).double()).abs()
    scale = conv(x64.abs(), w64.abs(), b64.abs(), torch.float64).double()
    return float((err / (2.0 ** -24 * scale).clamp(min=1e-300)).max())


def report(case, a, b, tol, bounds, noise):
    lo, hi, two = bounds
    a, b = a.double(), b.double()
    outside = sum(int(((lo - v).clamp(min=0) + (v - hi).clamp(min=0)
                       > tol).sum()) for v in (a, b))
    print(json.dumps({
        **case, "outputs": a.numel(),
        "beyond_plain_tolerance": int(((a - b).abs() > tol).sum()),
        "outside_range": outside, "two_roundings": two,
        "share_range_wider_than_tolerance": float(
            ((hi - lo) > tol).double().mean()),
        "max_fp32_noise_units": noise}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--views", type=int, default=2)
    args = ap.parse_args()
    dev = args.device
    g = torch.Generator().manual_seed(0)
    sd = load_npz_checkpoint(os.path.join(ROOT, "checkpoints",
                                          "model_dtu.npz"))
    for stage, hd, H, W in GRU_STAGES:
        pre = f"update_block_depth{stage}.depth_gru."
        p = [sd[pre + k].to(dev) for k in (
            "convz.weight", "convr.weight", "convq.weight", "convz.bias",
            "convr.bias", "convq.bias")]
        h = torch.tanh(torch.randn((2, H, W, hd), generator=g)).bfloat16()
        x = torch.relu(torch.randn((2, H, W, hd), generator=g)).bfloat16()
        h, x = h.to(dev), x.to(dev)
        a = gru(h, x, *p, torch.float32)
        b = gru(h, x, *p, torch.float64).bfloat16().float()
        report({"kernel": "K2", "stage": stage, "shape": [2, H, W, hd]},
               a, b, 1e-4 + 2.0 ** -8 * a.abs().double(),
               rounding_bounds.gru_bounds(h, x, *p),
               noise_units(torch.cat([h, x], -1),
                           p[1].to(h.dtype).float(), p[4]))
        del h, x, a, b

    model = build_model(load_npz_checkpoint(os.path.join(
        ROOT, "checkpoints", "model_tank.npz")),
        EffiMVSConfig(ndepths=(96, 8, 8)), device=dev)
    x = torch.rand((args.views, 1056, 1920, 3), generator=g).to(dev)
    net = model.feature
    with torch.no_grad():
        for i in range(4):
            blocks = list(getattr(net, f"conv{i}"))
            if i:
                x = blocks.pop(0)(x)
            specs = [cuda_conv.fold_bn(b.conv.weight, b.bn) for b in blocks]
            xb = x.to(torch.bfloat16)
            a = chain(xb, specs, torch.float32).float()
            b = chain(xb, specs, torch.float64).float()
            tol = (5e-5 + len(specs) * 2.0 ** -8) * a.abs().clamp(
                min=1.0).double()
            ys = [xb]
            for w, bias in specs[:-1]:
                ys.append(chain(ys[-1], [(w, bias)], torch.float32))
            report({"kernel": "K4", "chain": f"feature conv{i}",
                    "shape": list(xb.shape) + [w.shape[0] for w, _ in specs]},
                   a, b, tol, rounding_bounds.chain_bounds(xb, specs),
                   max(noise_units(y, w.to(y.dtype).float(), bias)
                       for y, (w, bias) in zip(ys, specs)))
            x = chain(x, specs, torch.float32)     # the next level's input


if __name__ == "__main__":
    main()
