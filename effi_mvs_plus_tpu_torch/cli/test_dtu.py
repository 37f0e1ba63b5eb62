"""DTU inference + dypcd fusion CLI.

Port of ``effi_mvs_plus_tpu/cli/test_dtu.py``: saves per-view depth,
confidence, cams and preview images, then fuses each scan with the dynamic
consistency filter into mvsnetXXX_l3.ply point clouds.  Depth inference
batches reference views on ``--device`` (``cuda`` unless told otherwise;
with no GPU the default raises).  Fusion runs on ``--device`` too: on
the card scan after scan, as one process holds the card; with ``--device
cpu`` in a ``spawn`` pool of ``--num_worker`` processes (the JAX CLI's
flag), one scan each, when there are several scans.  ``--loadckpt`` takes
any checkpoint ``io.load_state_dict`` reads: a shipped ``.npz``, a port
or reference torch ``.ckpt``, or a JAX train checkpoint.

Multi-process (``torchrun``, one process per GPU): each rank infers and
fuses its round-robin share of the scans.

Usage:
  python -m effi_mvs_plus_tpu_torch.cli.test_dtu --testpath <dtu_testing> \\
      --testlist lists/dtu/test.txt --loadckpt checkpoints/model_dtu.npz \\
      --outdir out
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser(profile_name="dtu_eval"):
    from effi_mvs_plus_tpu_torch.config import (apply_profile_defaults,
                                                get_profile)
    p = argparse.ArgumentParser("effi-mvs-plus-tpu-torch test_dtu")
    p.add_argument("--profile", default=profile_name,
                   help="named preset from config.PROFILES")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of "
                        "the kernels")
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--loadckpt", required=True)
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--ndepths", type=str)
    p.add_argument("--GRUiters", type=str, default="3,3,3")
    p.add_argument("--CostNum", type=int)
    p.add_argument("--numdepth", type=int)
    p.add_argument("--interval_scale", type=float)
    p.add_argument("--num_view", type=int)
    p.add_argument("--max_h", type=int)
    p.add_argument("--max_w", type=int)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--conf", type=float)
    p.add_argument("--dist_base", type=float)
    p.add_argument("--diff_base", type=float)
    p.add_argument("--num_worker", type=int, default=4,
                   help="with --device cpu, scans fused at once in a spawn "
                        "pool; on the card, scans are fused one after "
                        "another whatever this says (one process holds "
                        "the card)")
    p.add_argument("--save_masks", action="store_true",
                   help="write per-ref photo/geo/final mask PNGs")
    p.add_argument("--skip_depth", action="store_true",
                   help="fuse only (depth maps already saved)")
    p.add_argument("--skip_fusion", action="store_true")
    apply_profile_defaults(p, get_profile(profile_name))
    return p


def save_depths(args, scans):
    """Depth inference for every scan, in bf16 compute.  Returns
    {scan: the engine's save_scene_depths stats}."""
    from effi_mvs_plus_tpu_torch.data.datasets import GeneralEvalDataset
    from effi_mvs_plus_tpu_torch.data.loader import Loader
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig

    cfg = EffiMVSConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        gru_iters=tuple(int(x) for x in args.GRUiters.split(",")),
        CostNum=args.CostNum, compute_dtype=torch.bfloat16)
    engine = InferenceEngine(load_state_dict(args.loadckpt), cfg,
                             device=args.device)
    out = {}
    for scan in scans:
        ds = GeneralEvalDataset(args.testpath, [scan], args.num_view,
                                args.numdepth, args.interval_scale,
                                max_h=args.max_h, max_w=args.max_w)
        loader = Loader(ds, args.batch_size, num_workers=4)
        out[scan] = stats = engine.save_scene_depths(loader, args.outdir,
                                                     verbose=False)
        print(f"{scan}: {stats['maps']} maps, "
              f"{stats['s_per_map']:.3f}s/map", flush=True)
    return out


def fuse_scan(args, scan):
    """Fuse one scan's saved depth maps into mvsnetXXX_l3.ply on
    ``args.device``.  Returns (ply path, point count)."""
    from effi_mvs_plus_tpu_torch.config import DypcdParams
    from effi_mvs_plus_tpu_torch.data import read_cam_file, read_pair_file
    from effi_mvs_plus_tpu_torch.data.datasets import _resize_bilinear
    from effi_mvs_plus_tpu_torch.data.pfm import read_pfm
    from effi_mvs_plus_tpu_torch.fuse import fuse_scene, write_ply

    pair = read_pair_file(os.path.join(args.testpath, scan, "pair.txt"))
    out_folder = os.path.join(args.outdir, scan)

    def load_view(vid):
        cam = read_cam_file(
            os.path.join(out_folder, "cams", f"{vid:08d}_cam.txt"))
        depth = read_pfm(
            os.path.join(out_folder, "depth_est", f"{vid:08d}.pfm"))[0]
        conf_map = read_pfm(
            os.path.join(out_folder, "confidence", f"{vid:08d}.pfm"))[0]
        if conf_map.shape != depth.shape:
            conf_map = _resize_bilinear(conf_map,
                                        (depth.shape[1], depth.shape[0]))
        img_path = os.path.join(out_folder, "images", f"{vid:08d}.jpg")
        img = None
        if os.path.exists(img_path):
            from PIL import Image
            img = np.array(Image.open(img_path), np.float32) / 255.0
        return {"depth": depth, "conf": conf_map,
                "K": cam["intrinsics"], "E": cam["extrinsics"],
                "image": img}

    xyz, rgb = fuse_scene(pair, load_view,
                          DypcdParams(conf_thresh=args.conf,
                                      dist_base=args.dist_base,
                                      diff_base=args.diff_base),
                          progress=lambda r, p, g, f: print(
                              f"{scan} ref {r:02d} photo/geo/final "
                              f"{p:.3f}/{g:.3f}/{f:.3f}", flush=True),
                          mask_dir=(os.path.join(out_folder, "mask")
                                    if args.save_masks else None),
                          device=args.device)
    scan_id = int(scan[4:]) if scan.startswith("scan") else 0
    ply_path = os.path.join(args.outdir, f"mvsnet{scan_id:03d}_l3.ply")
    write_ply(ply_path, xyz, rgb)
    print(f"saved {ply_path} ({len(xyz)} points)", flush=True)
    return ply_path, len(xyz)


def main(argv=None):
    # two-phase parse: --profile picks the preset the remaining defaults
    # come from; explicit flags still win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--profile", default="dtu_eval")
    ns, _ = pre.parse_known_args(argv)
    args = build_parser(ns.profile).parse_args(argv)
    with open(args.testlist) as f:
        scans = [ln.strip() for ln in f if ln.strip()]
    # each process owns a round-robin share of the scans (inference and
    # fusion are independent per scan)
    from effi_mvs_plus_tpu_torch import parallel
    if parallel.initialize(device=args.device):
        args.device = str(parallel.rank_device(args.device))
        scans = parallel.partition(scans)
        print(f"process {parallel.rank()}: {len(scans)} scans", flush=True)
    if not args.skip_depth:
        save_depths(args, scans)
    if not args.skip_fusion:
        fuse_scans(args, scans)
    parallel.barrier()


def fuse_scans(args, scans):
    """``fuse_scan`` of every scan: in a ``spawn`` pool of up to
    ``--num_worker`` processes on the CPU, else one after another."""
    workers = min(args.num_worker, len(scans))
    if torch.device(args.device).type != "cpu" or workers <= 1:
        for scan in scans:
            fuse_scan(args, scan)
        return
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(workers) as pool:
        pool.starmap(fuse_scan, [(args, scan) for scan in scans])


if __name__ == "__main__":
    main()
