"""Dynamic point-cloud fusion (dypcd) and the Tanks & Temples dynamic
fusion, as torch functions on the device their tensors are on.

Port of ``effi_mvs_plus_tpu/fuse/dypcd.py``.  For every reference view,
reproject through each source view's depth map (ref -> src -> ref), apply
the dynamic consistency ladder

    mask_i = (reproj_dist < i * dist_base)
             & (|depth_reproj - depth_ref| < log10(max(i, 1.05)) * diff_base)
    keep   = OR_i ( #views passing level i  >=  i ),        i in [s, e)

average the passing reprojected depths with the reference (high-confidence
pixels keep the reference depth), and back-project to world points.  The
JAX package's ``vmap`` over source views (and ``lax.map`` over reference
views) are batch axes here: every geometry function broadcasts over
leading dimensions.

Geometry runs in true fp32: on a GPU ``device.resolve_device`` turns TF32
off for matmuls and cuDNN before the first product, and 3x3 inverses are
the closed-form ``core.geometry.inv3x3``.  The remap is the port's
``ops.warp.bilinear_gather`` (grid_sample semantics, zeros padding).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from effi_mvs_plus_tpu_torch.config import DypcdParams, TankParams
from effi_mvs_plus_tpu_torch.core.geometry import inv3x3
from effi_mvs_plus_tpu_torch.device import resolve_device
from effi_mvs_plus_tpu_torch.ops.warp import bilinear_gather


def _pixel_xy(H, W, device):
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return x, y


def _apply(M, pts):
    """(...,3,3) matrices applied to (...,H,W,3) points."""
    return torch.einsum("...ij,...hwj->...hwi", M, pts)


def _cam_rays(K_inv, depth):
    """Back-project depth maps: (...,3,3) K^-1, (...,H,W) depth ->
    (...,H,W,3) camera points."""
    x, y = _pixel_xy(*depth.shape[-2:], depth.device)
    pix = torch.stack([x, y, torch.ones_like(x)], -1)
    return _apply(K_inv, pix) * depth[..., None]


def _rigid_inv(E):
    """Inverse of rigid (...,4,4) [R|t]: [R^T | -R^T t], exact where an LU
    inverse loses fp32 digits."""
    Rt = E[..., :3, :3].transpose(-1, -2)
    t = E[..., :3, 3:4]
    return torch.cat([torch.cat([Rt, -(Rt @ t)], -1), E[..., 3:4, :]], -2)


def _reproject_one(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    """ref -> src -> ref reprojection; every argument broadcasts over
    leading dimensions (the source-view axis, and a reference axis).
    depth (...,H,W), K (...,3,3), E (...,4,4).  Returns (depth_reprojected,
    x_rep, y_rep), each (...,H,W)."""
    resolve_device(depth_ref.device)          # true fp32 on a GPU
    H, W = depth_ref.shape[-2:]
    rel = E_src @ _rigid_inv(E_ref)
    rel_back = E_ref @ _rigid_inv(E_src)
    xyz_ref = _cam_rays(inv3x3(K_ref), depth_ref)
    xyz_src = _apply(rel[..., :3, :3], xyz_ref) + rel[..., None, None, :3, 3]
    kxyz = _apply(K_src, xyz_src)
    x_src = kxyz[..., 0] / kxyz[..., 2]
    y_src = kxyz[..., 1] / kxyz[..., 2]

    batch = x_src.shape[:-2]
    sampled = bilinear_gather(
        depth_src.expand(*batch, H, W).reshape(-1, H, W, 1),
        x_src.reshape(-1, H * W), y_src.reshape(-1, H * W))
    sampled = sampled.reshape(x_src.shape)

    pix_src = torch.stack([x_src, y_src, torch.ones_like(x_src)], -1)
    xyz_src2 = _apply(inv3x3(K_src), pix_src) * sampled[..., None]
    xyz_rep = (_apply(rel_back[..., :3, :3], xyz_src2)
               + rel_back[..., None, None, :3, 3])
    kxyz_rep = _apply(K_ref, xyz_rep)
    zr = kxyz_rep[..., 2]
    zr = torch.where(zr == 0, zr + 1e-5, zr)
    return xyz_rep[..., 2], kxyz_rep[..., 0] / zr, kxyz_rep[..., 1] / zr


def _dynamic_ladder(depth_ref, depth_rep, x_rep, y_rep, levels, dist_thresh,
                    diff_thresh, vote_over, relative=False):
    """Shared dynamic-consistency core.

    depth_ref (...,H,W); depth_rep/x_rep/y_rep (...,S,H,W) reprojections;
    levels/dist_thresh/diff_thresh (L,) threshold ladder; vote_over: the
    count needed at the final OR (an unreachable ``>= e`` term kept for
    parity with the reference).  Returns (geo_mask, fused) (...,H,W).
    """
    x, y = _pixel_xy(*depth_ref.shape[-2:], depth_ref.device)
    ref = depth_ref[..., None, :, :]
    dist = torch.sqrt((x_rep - x) ** 2 + (y_rep - y) ** 2)
    depth_diff = torch.abs(depth_rep - ref)
    if relative:
        depth_diff = depth_diff / ref

    lv = (-1, 1, 1, 1)
    masks = ((dist[..., None, :, :, :] < dist_thresh.view(lv))
             & (depth_diff[..., None, :, :, :] < diff_thresh.view(lv)))
    # (...,L,S,H,W)
    top_mask = masks[..., -1, :, :, :]
    counts = masks.sum(-3, dtype=torch.int32)                  # (...,L,H,W)
    geo_mask = (counts >= levels.view(-1, 1, 1)).any(-3)
    geo_mask = geo_mask | (top_mask.sum(-3, dtype=torch.int32) >= vote_over)

    depth_sum = torch.where(top_mask, depth_rep, 0.0).sum(-3)
    n_pass = top_mask.float().sum(-3)
    return geo_mask, (depth_sum + depth_ref) / (n_pass + 1.0)


def _consistency_one(depth_ref, conf_ref, K_ref, E_ref, depth_srcs, K_srcs,
                     E_srcs, params: DypcdParams):
    """DTU dypcd ladder for reference views (...,H,W) against their
    sources (...,S,H,W)."""
    depth_rep, x_rep, y_rep = _reproject_one(
        depth_ref[..., None, :, :], K_ref[..., None, :, :],
        E_ref[..., None, :, :], depth_srcs, K_srcs, E_srcs)
    levels = torch.arange(params.s, params.e, dtype=torch.float32,
                          device=depth_ref.device)
    geo_mask, fused = _dynamic_ladder(
        depth_ref, depth_rep, x_rep, y_rep, levels,
        levels * params.dist_base,
        torch.log10(torch.clamp(levels, min=1.05)) * params.diff_base,
        vote_over=params.e)
    fused = torch.where(conf_ref > params.conf_override, depth_ref, fused)
    photo_mask = conf_ref > params.conf_thresh
    return photo_mask & geo_mask, fused, geo_mask, photo_mask


def consistency(depth_ref, conf_ref, K_ref, E_ref, depth_srcs, K_srcs,
                E_srcs, params: DypcdParams = DypcdParams()):
    """DTU dypcd fusion for one reference view.

    depth_ref/conf_ref (H,W); depth_srcs (S,H,W); K_srcs/E_srcs
    (S,3,3)/(S,4,4).  Returns (final_mask (H,W) bool, fused_depth (H,W),
    geo_mask, photo_mask)."""
    return _consistency_one(depth_ref, conf_ref, K_ref, E_ref, depth_srcs,
                            K_srcs, E_srcs, params)


def consistency_scene(depth, conf, K, E, ref_ids, src_ids,
                      params: DypcdParams = DypcdParams(), chunk: int = 4):
    """Whole-scan dypcd fusion with the views resident on one device,
    ``chunk`` references at a time to bound the (chunk,L,S,H,W) masks.

    depth/conf (N,H,W); K (N,3,3); E (N,4,4); ref_ids (R,) and src_ids
    (R,S) integer rows into the N stack.  Returns (final (R,H,W) bool,
    fused (R,H,W), geo (R,H,W), photo (R,H,W))."""
    parts = []
    for i in range(0, len(ref_ids), chunk):
        rid, srow = ref_ids[i:i + chunk], src_ids[i:i + chunk]
        parts.append(_consistency_one(depth[rid], conf[rid], K[rid], E[rid],
                                      depth[srow], K[srow], E[srow], params))
    return tuple(torch.cat(p) for p in zip(*parts))


def consistency_tank(depth_ref, conf_ref, K_ref, E_ref, depth_srcs, K_srcs,
                     E_srcs, params: TankParams = TankParams()):
    """T&T dynamic fusion for one reference view: threshold ladder i in
    [dh_view_num, S+1) with dist < i/dist_filter and depth_diff <
    i/depth_filter; no high-confidence override.  Shapes as
    ``consistency``."""
    S = depth_srcs.shape[0]
    photo_mask = conf_ref > params.prob_threshold
    if S < params.dh_view_num + 1:
        # too few source views to ever satisfy the vote (the reference
        # CLI skips these refs)
        zeros = torch.zeros_like(depth_ref, dtype=torch.bool)
        return zeros, depth_ref, zeros, photo_mask
    depth_rep, x_rep, y_rep = _reproject_one(
        depth_ref, K_ref, E_ref, depth_srcs, K_srcs, E_srcs)
    levels = torch.arange(params.dh_view_num, S + 1, dtype=torch.float32,
                          device=depth_ref.device)
    geo_mask, fused = _dynamic_ladder(
        depth_ref, depth_rep, x_rep, y_rep, levels,
        levels / params.dist_filter, levels / params.depth_filter,
        vote_over=S + 1, relative=params.relative)
    return photo_mask & geo_mask, fused, geo_mask, photo_mask


def backproject_to_world(depth, mask, K, E):
    """Masked pixels -> world points, in float64 on the host (numpy; the
    point count is data dependent).  Returns (xyz (N,3) float32,
    (ys, xs))."""
    ys, xs = np.nonzero(np.asarray(mask))
    d = np.asarray(depth)[ys, xs]
    pix = np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64) * d
    xyz_cam = np.linalg.inv(np.asarray(K, np.float64)) @ pix
    xyz_w = (np.linalg.inv(np.asarray(E, np.float64))
             @ np.vstack([xyz_cam, np.ones_like(d)]))[:3]
    return xyz_w.T.astype(np.float32), (ys, xs)


def save_mask_pngs(mask_dir, ref, photo_mask, geo_mask, final_mask):
    """The fusion-debug images the reference writes per reference view:
    mask/<ref>_photo.png, _geo.png, _final.png as 0/255 images (skipped
    where PIL is missing)."""
    os.makedirs(mask_dir, exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        return
    for name, m in (("photo", photo_mask), ("geo", geo_mask),
                    ("final", final_mask)):
        img = np.asarray(m).astype(np.uint8) * 255
        Image.fromarray(img).save(
            os.path.join(mask_dir, f"{ref:08d}_{name}.png"))


def _host(t):
    return t.cpu().numpy()


def _collect(ref, r, final, fused, geo, photo, out, mask_dir, progress):
    """Back-project one reference view's fused depths and record its
    colours, masks and progress."""
    xyz, (ys, xs) = backproject_to_world(fused, final, r["K"], r["E"])
    out["xyz"].append(xyz)
    if r.get("image") is not None:
        img = np.asarray(r["image"])
        out["rgb"].append((img[ys, xs] * 255).astype(np.uint8))
    if mask_dir is not None:
        save_mask_pngs(mask_dir, ref, photo, geo, final)
    if progress is not None:
        progress(ref, float(photo.mean()), float(geo.mean()),
                 float(final.mean()))


def _cloud(out):
    xyz = (np.concatenate(out["xyz"], 0) if out["xyz"]
           else np.zeros((0, 3), np.float32))
    rgb = (np.concatenate(out["rgb"], 0)
           if out["rgb"] and len(out["rgb"]) == len(out["xyz"]) else None)
    return xyz, rgb


def fuse_scene_device(pair_data, views, params: DypcdParams = DypcdParams(),
                      progress=None, mask_dir=None, chunk: int = 4,
                      device=None):
    """Fuse one scene with every view resident on ``device`` (``cuda``
    unless the caller names another), one ``consistency_scene`` call per
    source-count group.

    pair_data: [(ref_view, [src_views...])]
    views: view_id -> dict(depth (H,W), conf (H,W), K (3,3), E (4,4),
           image (H,W,3) float [0,1] or None); every view referenced by
           pair_data shares (H,W).
    Returns (xyz (N,3) float32, rgb (N,3) uint8 or None).
    """
    dev = resolve_device(device)
    vids = sorted(views)
    row = {v: i for i, v in enumerate(vids)}

    def stack(key):
        return torch.from_numpy(np.stack(
            [np.asarray(views[v][key], np.float32) for v in vids])).to(dev)

    depth, conf, K, E = (stack(k) for k in ("depth", "conf", "K", "E"))
    groups = {}
    for ref, srcs in pair_data:
        groups.setdefault(len(srcs), []).append((ref, srcs))

    out = {"xyz": [], "rgb": []}
    for S, group in sorted(groups.items()):
        if S == 0:
            continue
        ref_ids = torch.tensor([row[r] for r, _ in group], device=dev)
        src_ids = torch.tensor([[row[s] for s in srcs] for _, srcs in group],
                               device=dev)
        final, fused, geo, photo = (_host(t) for t in consistency_scene(
            depth, conf, K, E, ref_ids, src_ids, params, chunk))
        for i, (ref, _) in enumerate(group):
            _collect(ref, views[ref], final[i], fused[i], geo[i], photo[i],
                     out, mask_dir, progress)
    return _cloud(out)


def fuse_scene(pair_data, load_view, params: DypcdParams = DypcdParams(),
               progress=None, mask_dir=None, device=None):
    """Fuse one scene into a point cloud.

    pair_data: [(ref_view, [src_views...])]
    load_view: view_id -> dict(depth (H,W), conf (H,W), K (3,3), E (4,4),
               image (H,W,3) float [0,1] or None)
    mask_dir: when set, write per-ref photo/geo/final mask PNGs there.
    Returns (xyz (N,3) float32, rgb (N,3) uint8 or None).

    Loads every referenced view once, then fuses with the batched
    ``fuse_scene_device`` when all views share one shape, and one
    reference at a time otherwise.
    """
    needed = sorted({v for ref, srcs in pair_data for v in [ref, *srcs]})
    views = {v: load_view(v) for v in needed}
    shapes = {np.asarray(views[v]["depth"]).shape for v in needed}
    if len(shapes) == 1:
        return fuse_scene_device(pair_data, views, params, progress=progress,
                                 mask_dir=mask_dir, device=device)

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    out = {"xyz": [], "rgb": []}
    for ref, srcs in pair_data:
        r = views[ref]
        sv = [views[s] for s in srcs]
        final, fused, geo, photo = (_host(x) for x in consistency(
            t(r["depth"]), t(r["conf"]), t(r["K"]), t(r["E"]),
            t(np.stack([s["depth"] for s in sv])),
            t(np.stack([s["K"] for s in sv])),
            t(np.stack([s["E"] for s in sv])), params))
        _collect(ref, r, final, fused, geo, photo, out, mask_dir, progress)
    return _cloud(out)
