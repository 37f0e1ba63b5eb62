"""DTU benchmark evaluation CLI — the MATLAB protocol, self-contained.

Port of ``effi_mvs_plus_tpu/cli/eval_dtu.py`` (numpy and scipy, no
device): the reference's BaseEvalMain_web.m + ComputeStat_web.m, per-scan
chamfer accuracy/completeness of the fused mvsnetXXX_l3.ply clouds
against the structured-light ground truth, with ObsMask/ground-plane
filtering, 20 mm outlier cut, 0.2 mm downsample;
overall = (mean acc + mean comp) / 2 over the scans evaluated.

Expects the official "SampleSet/MVS Data" layout:
  <gtpath>/Points/stl/stl{scan:03d}_total.ply
  <gtpath>/ObsMask/ObsMask{scan}_10.mat, Plane{scan}.mat

Usage:
  python -m effi_mvs_plus_tpu_torch.cli.eval_dtu --plydir out \
      --gtpath <SampleSet/MVS Data> --testlist lists/dtu/test.txt
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os


def build_parser():
    p = argparse.ArgumentParser("effi-mvs-plus-tpu-torch eval_dtu")
    p.add_argument("--plydir", required=True,
                   help="directory holding mvsnetXXX_l3.ply")
    p.add_argument("--gtpath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--dst", type=float, default=0.2)
    p.add_argument("--max_dist", type=float, default=20.0)
    p.add_argument("--num_worker", type=int, default=4)
    p.add_argument("--out", default=None, help="optional JSON result path")
    p.add_argument("--dump_obj", default=None, metavar="DIR",
                   help="write BaseEval2Obj_web.m-style error-coloured "
                        "OBJs per scan into DIR")
    return p


def eval_one(task):
    scan_id, plydir, gtpath, dst, max_dist, dump_obj = task
    import numpy as np
    from effi_mvs_plus_tpu_torch.eval import dtu as E
    from effi_mvs_plus_tpu_torch.fuse.ply import read_ply

    method, _ = read_ply(
        os.path.join(plydir, f"mvsnet{scan_id:03d}_l3.ply"))
    stl, _ = read_ply(os.path.join(
        gtpath, "Points", "stl", f"stl{scan_id:03d}_total.ply"))
    obs_mask, bb, res = E.load_obs_mask(os.path.join(
        gtpath, "ObsMask", f"ObsMask{scan_id}_10.mat"))
    plane = E.load_plane(os.path.join(gtpath, "ObsMask",
                                      f"Plane{scan_id}.mat"))
    r = E.evaluate_scan(np.asarray(method, np.float64),
                        np.asarray(stl, np.float64),
                        obs_mask, bb, res, plane, dst=dst,
                        max_dist=max_dist,
                        return_artifacts=dump_obj is not None)
    if dump_obj is not None:
        E.export_error_obj(r, "mvsnet", scan_id, dump_obj)
        # artifacts are large per-point arrays — drop them before the
        # result rides the multiprocessing pipe back to the parent
        r.q_data = r.d_data = r.data_in_mask = None
        r.q_stl = r.d_stl = r.stl_above_plane = None
    print(f"scan{scan_id}: acc {r.acc_mean:.4f} comp {r.comp_mean:.4f}",
          flush=True)
    return scan_id, r


def main(argv=None):
    args = build_parser().parse_args(argv)
    from effi_mvs_plus_tpu_torch.eval.dtu import aggregate

    with open(args.testlist) as f:
        scans = [ln.strip() for ln in f if ln.strip()]
    ids = [int(s[4:]) if s.startswith("scan") else int(s) for s in scans]
    tasks = [(i, args.plydir, args.gtpath, args.dst, args.max_dist,
              args.dump_obj) for i in ids]
    if args.num_worker <= 1:
        results = [eval_one(t) for t in tasks]
    else:
        with mp.get_context("spawn").Pool(args.num_worker) as pool:
            results = pool.map(eval_one, tasks)

    stats = aggregate([r for _, r in results])
    stats["per_scan"] = {f"scan{i}": {"acc": r.acc_mean, "comp": r.comp_mean}
                         for i, r in results}
    print(json.dumps({k: stats[k] for k in
                      ("mean_acc_mm", "mean_comp_mm", "overall_mm")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stats, f, indent=2)
    return stats


if __name__ == "__main__":
    main()
