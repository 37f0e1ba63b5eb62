"""Tanks & Temples inference + dynamic fusion CLI.

Port of ``effi_mvs_plus_tpu/cli/test_tank.py``: per-scene depth inference
at 1920x1056 with 11 views (ndepths 96,8,8, bf16 compute), then the
dynamic visibility fusion with the per-scene filter configs, writing
<scene>.ply.  Runs on ``--device`` (``cuda`` unless told otherwise; with
no GPU the default raises).  ``--loadckpt`` takes any checkpoint
``io.load_state_dict`` reads: a shipped ``.npz``, a port or reference
torch ``.ckpt``, or a JAX train checkpoint.

Multi-process (``torchrun``, one process per GPU): each rank infers and
fuses its round-robin share of ``--scenes``; with ``--shard_views`` the
ranks instead split the source views of every request
(``InferenceEngine(shard_policy="views")``) and rank 0 writes the maps and
fuses.

Usage:
  python -m effi_mvs_plus_tpu_torch.cli.test_tank --testpath <tt_root> \\
      --loadckpt checkpoints/model_tank.npz --outdir out --scenes Horse
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os

import numpy as np
import torch


def build_parser(profile_name="tank_eval"):
    from effi_mvs_plus_tpu_torch.config import (apply_profile_defaults,
                                                get_profile)
    p = argparse.ArgumentParser("effi-mvs-plus-tpu-torch test_tank")
    p.add_argument("--profile", default=profile_name,
                   help="named preset from config.PROFILES")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    p.add_argument("--testpath", required=True)
    p.add_argument("--loadckpt", required=True)
    p.add_argument("--outdir", default="./outputs/tank")
    p.add_argument("--savedir", default=None)
    p.add_argument("--scenes", nargs="+", default=["Horse"])
    p.add_argument("--ndepths", type=str)
    p.add_argument("--GRUiters", type=str, default="3,3,3")
    p.add_argument("--CostNum", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--num_view", type=int)
    # the reference reader's 1920x1056, exposed so synthetic rigs run the
    # same chain at reduced resolution
    p.add_argument("--max_h", type=int, default=1056)
    p.add_argument("--max_w", type=int, default=1920)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--shard_views", action="store_true",
                   help="multi-process: every rank works on each request, "
                        "on its block of the source views")
    p.add_argument("--skip_depth", action="store_true")
    p.add_argument("--skip_fusion", action="store_true")
    # overrides of the per-scene filter config (TANK_FILTER_CONFIGS stays
    # the deployed default; synthetic rigs at other scales need
    # rig-appropriate thresholds)
    p.add_argument("--dist_filter", type=float, default=None)
    p.add_argument("--depth_filter", type=float, default=None)
    p.add_argument("--prob_threshold", type=float, default=None)
    p.add_argument("--dh_view_num", type=int, default=None)
    apply_profile_defaults(p, get_profile(profile_name))
    return p


def save_depths(args):
    """Depth inference for every scene of ``args.scenes``, in bf16
    compute.  Returns {scene: the engine's save_scene_depths stats}."""
    from effi_mvs_plus_tpu_torch.data.datasets import TanksDataset
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig

    cfg = EffiMVSConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        gru_iters=tuple(int(x) for x in args.GRUiters.split(",")),
        CostNum=args.CostNum, compute_dtype=torch.bfloat16)
    engine = InferenceEngine(load_state_dict(args.loadckpt), cfg,
                             device=args.device,
                             shard_policy="views" if args.shard_views
                             else None)
    out = {}
    for scene in args.scenes:
        ds = TanksDataset(args.testpath, [scene], args.num_view,
                          args.numdepth, target_wh=(args.max_w, args.max_h))
        loader = Loader(ds, args.batch_size, num_workers=4)
        out[scene] = stats = engine.save_scene_depths(loader, args.outdir,
                                                      verbose=False)
        print(f"{scene}: {stats['maps']} maps, "
              f"{stats['s_per_map']:.3f}s/map", flush=True)
    return out


def fuse_scene_tank(args, scene):
    """Dynamic fusion of one scene's saved depth maps into
    <savedir or outdir>/<scene>.ply.  Returns (ply path, point count)."""
    from effi_mvs_plus_tpu_torch.config import TANK_FILTER_CONFIGS, TankParams
    from effi_mvs_plus_tpu_torch.data import read_cam_file, read_pair_file
    from effi_mvs_plus_tpu_torch.data.datasets import tank_split
    from effi_mvs_plus_tpu_torch.data.pfm import read_pfm
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.fuse.dypcd import (backproject_to_world,
                                                    consistency_tank)
    from effi_mvs_plus_tpu_torch.fuse.ply import write_ply

    dev = resolve_device(args.device)
    pair = read_pair_file(os.path.join(args.testpath, tank_split(scene),
                                       scene, "pair.txt"))
    out_folder = os.path.join(args.outdir, scene)
    params = TANK_FILTER_CONFIGS.get(scene, TankParams())
    overrides = {k: getattr(args, k) for k in
                 ("dist_filter", "depth_filter", "prob_threshold",
                  "dh_view_num") if getattr(args, k, None) is not None}
    if overrides:
        params = dataclasses.replace(params, **overrides)

    # each view is read about ten times a scene (once per ref using it as
    # a source); the cache bound keeps a 1920x1056 scene near 400 MB
    @functools.lru_cache(maxsize=48)
    def load_view(vid):
        cam = read_cam_file(
            os.path.join(out_folder, "cams", f"{vid:08d}_cam.txt"))
        depth = read_pfm(
            os.path.join(out_folder, "depth_est", f"{vid:08d}.pfm"))[0]
        conf = read_pfm(
            os.path.join(out_folder, "confidence", f"{vid:08d}.pfm"))[0]
        if conf.shape != depth.shape:
            # nearest upsample of the half-resolution confidence
            conf = np.repeat(np.repeat(
                conf, depth.shape[0] // conf.shape[0], 0),
                depth.shape[1] // conf.shape[1], 1)
        img_path = os.path.join(out_folder, "images", f"{vid:08d}.jpg")
        img = None
        if os.path.exists(img_path):
            from PIL import Image
            img = np.array(Image.open(img_path), np.float32) / 255.0
        return {"depth": depth, "conf": conf, "K": cam["intrinsics"],
                "E": cam["extrinsics"], "image": img}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    all_xyz, all_rgb = [], []
    for ref, srcs in pair:
        srcs = srcs[:params.views - 1]
        if len(srcs) < params.dh_view_num + 1:
            continue
        r = load_view(ref)
        sv = [load_view(s) for s in srcs]
        final, fused, geo, photo = (x.cpu().numpy() for x in consistency_tank(
            t(r["depth"]), t(r["conf"]), t(r["K"]), t(r["E"]),
            t(np.stack([s["depth"] for s in sv])),
            t(np.stack([s["K"] for s in sv])),
            t(np.stack([s["E"] for s in sv])), params))
        xyz, (ys, xs) = backproject_to_world(fused, final, r["K"], r["E"])
        all_xyz.append(xyz)
        if r["image"] is not None:
            all_rgb.append((r["image"][ys, xs] * 255).astype(np.uint8))
        print(f"{scene} ref {ref:02d} photo/geo/final "
              f"{photo.mean():.3f}/{geo.mean():.3f}/{final.mean():.3f}",
              flush=True)

    xyz = np.concatenate(all_xyz, 0)
    rgb = np.concatenate(all_rgb, 0) if len(all_rgb) == len(all_xyz) else None
    savedir = args.savedir or args.outdir
    os.makedirs(savedir, exist_ok=True)
    ply = os.path.join(savedir, f"{scene}.ply")
    write_ply(ply, xyz, rgb)
    print(f"saved {ply} ({len(xyz)} points)", flush=True)
    return ply, len(xyz)


def main(argv=None):
    # two-phase parse: --profile picks the preset the remaining defaults
    # come from; explicit flags still win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--profile", default="tank_eval")
    ns, _ = pre.parse_known_args(argv)
    args = build_parser(ns.profile).parse_args(argv)
    from effi_mvs_plus_tpu_torch import parallel
    if parallel.initialize(device=args.device):
        args.device = str(parallel.rank_device(args.device))
        if not args.shard_views:
            args.scenes = parallel.partition(args.scenes)
        print(f"process {parallel.rank()}: scenes {args.scenes}",
              flush=True)
    if not args.skip_depth:
        save_depths(args)
    if not args.skip_fusion and (not args.shard_views or parallel.is_main()):
        for scene in args.scenes:
            fuse_scene_tank(args, scene)
    parallel.barrier()


if __name__ == "__main__":
    main()
