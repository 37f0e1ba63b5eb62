#!/usr/bin/env python3
"""How far one DTU training step's gradients move, on the GPU, when the
port's kernels replace their plain versions, against how far they move
between two identical runs and under fp32 rounding of the input.

    python3 scripts/torch_grad_spread.py [--seeds 0,1,2] [--out FILE]

Needs one CUDA GPU and nvcc; imports nothing of JAX.  For each seed it
builds a batch of ``chip_smoke.py``'s DTU training config (B=4, 5 views,
640x512, 48/8/8, fp32, ``checkpoints/model_dtu.npz``, seeded noise images
and plane ground truth) and computes forward + ``mvs_loss`` + backward in
train mode, with dropout drawn from a generator seeded alike, under these
routings of the two kernel calls:

  kernels     K1 forward, K3 backward, K2 forward (the training path)
  kernels2    the same again
  plain       the plain versions of all three
  plain2      the same again
  nudged      plain, every image value moved one fp32 ulp (random sign)
  k1_plain_bwd  K1 forward, the plain backward in place of K3, plain GRU
  warp_kernels  K1 and K3, plain GRU
  gru_kernel  K2, plain warp
  plain_f64_proj  plain, the warp's projection and tap weights formed in
              float64 (the correctly rounded coordinates) before the
              fp32 gather

and prints one JSON line per seed and comparison: the worst leaf's
rel-l2 and its name, the 90th percentile, and the rel-l2 of the leaves
named by ``--watch``.  ``kernels`` vs ``plain`` is ``chip_smoke.py``'s
criterion; ``kernels2``/``plain2`` are the run-to-run spread;
``nudged`` is the step's own sensitivity to rounding its input;
``k1_plain_bwd``, ``warp_kernels`` and ``gru_kernel`` against ``plain``
take K1's forward rounding, K1 + K3, and K2 one at a time;
``plain_f64_proj`` against ``plain`` and ``kernels`` is how much the
step's gradients hang on rounding the projected coordinates at all.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the training config and its data)

COMPARE = (("kernels", "plain"), ("kernels2", "kernels"),
           ("plain2", "plain"), ("nudged", "plain"),
           ("k1_plain_bwd", "plain"), ("warp_kernels", "plain"),
           ("gru_kernel", "plain"), ("plain_f64_proj", "plain"),
           ("kernels", "plain_f64_proj"))


def routings(torch, cuda_warp, cuda_gru):
    """name -> (warp function, GRU function) for the model's two calls."""

    class K1PlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, ref, src, rots, trs, depth):
            ctx.save_for_backward(ref, src, rots, trs, depth)
            return cuda_warp._views_cuda(ref, src, rots, trs, depth)

        @staticmethod
        def backward(ctx, g):
            ref, src, rots, trs, depth = ctx.saved_tensors
            with torch.enable_grad():
                r = ref.detach().requires_grad_()
                s = src.detach().requires_grad_()
                out = cuda_warp._views_torch(r, s, rots, trs, depth)
                return (*torch.autograd.grad(out, (r, s), g),
                        None, None, None)

    def warp_plain(ref, src, rots, trs, depth):
        return cuda_warp._views_torch(ref, src, rots, trs, depth).to(
            ref.dtype)

    def warp_f64_proj(ref, src, rots, trs, depth):
        return cuda_warp._views_torch(ref, src, rots.double(), trs.double(),
                                      depth.double()).to(ref.dtype)

    def gru_plain(h, x, p, packed=None):
        return cuda_gru._gru_torch(h, x, p.convz.weight, p.convr.weight,
                                   p.convq.weight, p.convz.bias,
                                   p.convr.bias, p.convq.bias)
    warp_k, gru_k = cuda_warp.warp_correlate_views, cuda_gru.gru_step
    return {"kernels": (warp_k, gru_k), "kernels2": (warp_k, gru_k),
            "plain": (warp_plain, gru_plain),
            "plain2": (warp_plain, gru_plain),
            "nudged": (warp_plain, gru_plain),
            "k1_plain_bwd": (K1PlainBwd.apply, gru_plain),
            "warp_kernels": (warp_k, gru_plain),
            "gru_kernel": (warp_plain, gru_k),
            "plain_f64_proj": (warp_f64_proj, gru_plain)}


@contextlib.contextmanager
def routed(cuda_warp, cuda_gru, warp_fn, gru_fn):
    saved = cuda_warp.warp_correlate_views, cuda_gru.gru_step
    cuda_warp.warp_correlate_views, cuda_gru.gru_step = warp_fn, gru_fn
    try:
        yield
    finally:
        cuda_warp.warp_correlate_views, cuda_gru.gru_step = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--watch", default="CSP_R1.conv0.conv.weight")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_grad_spread: no CUDA device", file=sys.stderr)
        return 1
    from effi_mvs_plus_tpu_torch import nn
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from effi_mvs_plus_tpu_torch.ops import cuda_gru, cuda_warp
    from effi_mvs_plus_tpu_torch.train import trainer as T
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")            # TF32 off
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(load_npz_checkpoint(
        os.path.join(ROOT, "checkpoints", "model_dtu.npz")), strict=True)
    model.to(dev)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    routes = routings(torch, cuda_warp, cuda_gru)
    watch = args.watch.split(",")
    seeds = [int(x) for x in args.seeds.split(",")]
    B = chip_smoke.TRAIN["B"]
    batches = iter(Loader(chip_smoke.SyntheticDTU(B * (max(seeds) + 1),
                                                  camio), B, num_workers=2))
    lines = []
    for seed in range(max(seeds) + 1):
        batch = T.batch_to_device(next(batches), dev)   # samples seed*B..
        if seed not in seeds:
            continue
        rng = np.random.default_rng(seed)
        imgs = batch["imgs"].cpu().numpy()
        nudged = torch.from_numpy(np.nextafter(
            imgs, np.where(rng.random(imgs.shape) < 0.5, -np.inf,
                           np.inf)).astype(np.float32)).to(dev)
        grads, losses = {}, {}
        for name, (warp_fn, gru_fn) in routes.items():
            model.load_state_dict(saved)
            model.zero_grad(set_to_none=True)
            model.train()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            nn.use_generator(model, gen)
            with routed(cuda_warp, cuda_gru, warp_fn, gru_fn):
                out = model(nudged if name == "nudged" else batch["imgs"],
                            batch["proj_matrices"], batch["depth_values"])
                loss, _ = mvs_loss(out["depth"], batch["depth"],
                                   batch["mask"])
                loss.backward()
            losses[name] = loss.item()
            grads[name] = {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}
            del out, loss
        for a, b in COMPARE:
            rels = chip_smoke.grad_rels(grads[a], grads[b])
            by_leaf = {n: r for r, _, n in rels}
            line = {"seed": seed, "compare": f"{a} vs {b}",
                    "loss_rel": abs(losses[a] - losses[b]) / abs(losses[b]),
                    "worst_rel_l2": rels[-1][0], "worst_leaf": rels[-1][2],
                    "worst_cos": min(c for _, c, _ in rels),
                    "p90_rel_l2": rels[int(0.9 * len(rels))][0],
                    "top5": [[n, r] for r, _, n in rels[-5:][::-1]],
                    "watch": {n: by_leaf.get(n) for n in watch},
                    "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
        del grads
        torch.cuda.empty_cache()
    batches.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
