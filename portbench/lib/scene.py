"""Inputs made from the seed: a DTU-like camera rig looking at a few
textured slanted planes, rendered on the card.

The rig is a reference camera at the origin looking down +z and its
neighbours on a sphere around a point at the scene's depth, each turned
by (yaw, pitch) degrees and looking at that point, as DTU's structured
light stage places its cameras.  Intrinsics are the configuration's at
its image size.  The scene: one slanted background plane behind every
pixel and a few slanted textured rectangles in front of it, all inside
the configuration's depth band; a ray takes the nearest hit.  Textures
are multi-octave noise drawn with a ``torch.Generator`` on the device;
the planes' poses come from numpy's generator on the same seed.  Images
are quantised to 8 bits, as decoded photographs are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STAGE_SCALES = (0.5, 1.0, 2.0, 4.0)      # stage1..stage4 against quarter res
F64 = torch.float64


def look_at(center, target):
    """World->camera extrinsic (4x4) whose optical axis points at target
    (y down)."""
    z = np.asarray(target, np.float64) - np.asarray(center, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, y, z])
    E[:3, 3] = -E[:3, :3] @ np.asarray(center, np.float64)
    return E


def rig(scene_cfg, views):
    """[(K (3,3) at full resolution, E (4,4))] of the reference and
    ``views - 1`` neighbours."""
    fx, fy, cx, cy = scene_cfg["intrinsics"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    zc = scene_cfg["rig_distance"]
    target = np.array([0.0, 0.0, zc])
    cams = [(K, np.eye(4))]
    for yaw, pitch in scene_cfg["neighbour_deg"][:views - 1]:
        a, b = math.radians(yaw), math.radians(pitch)
        offset = np.array([math.sin(a) * math.cos(b), math.sin(b),
                           -math.cos(a) * math.cos(b)]) * zc
        cams.append((K, look_at(target + offset, target)))
    if len(cams) != views:
        raise ValueError(f"the rig has {len(cams)} cameras, {views} asked")
    return cams


def proj_matrices(cams):
    """{'stage1'..'stage4': (V, 2, 4, 4)}: extrinsics and the intrinsics
    at each stage's resolution (the model's input format)."""
    out = {}
    for i, s in enumerate(STAGE_SCALES):
        m = np.zeros((len(cams), 2, 4, 4), np.float32)
        for v, (K, E) in enumerate(cams):
            m[v, 0] = E
            m[v, 1, :3, :3] = K
            m[v, 1, :2, :] *= s / 4.0
        out[f"stage{i + 1}"] = m
    return out


def _texture(gen, size, device):
    tex = torch.zeros((size, size, 3), dtype=F64, device=device)
    for cells in (size, size // 4, size // 16, size // 64):
        oct_ = torch.rand((cells, cells, 3), generator=gen, device=device,
                          dtype=F64)
        reps = size // cells
        tex += oct_.repeat_interleave(reps, 0).repeat_interleave(reps, 1)
    tex -= tex.min()
    return tex / tex.max()


def _basis(normal):
    n = normal / np.linalg.norm(normal)
    e1 = np.cross([0.0, 1.0, 0.0], n)
    e1 /= np.linalg.norm(e1)
    return n, e1, np.cross(n, e1)


def planes(scene_cfg, seed_seq, device):
    """The scene of one batch row: a list of planes (centre, normal, the
    in-plane axes, half extents or None, texture)."""
    rng = np.random.default_rng(seed_seq)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    lo, hi = scene_cfg["background_depth"]
    tilt = math.radians(scene_cfg["max_tilt_deg"])
    out = []
    specs = [(rng.uniform(lo, hi), None)]
    flo, fhi = scene_cfg["front_depth"]
    elo, ehi = scene_cfg["front_half_extent"]
    for _ in range(scene_cfg["front_planes"]):
        specs.append((rng.uniform(flo, fhi), rng.uniform(elo, ehi, 2)))
    for depth, half in specs:
        a, b = rng.uniform(-tilt, tilt, 2)
        normal = np.array([math.sin(a), math.sin(b), -1.0])
        centre = np.array([0.0, 0.0, depth])
        if half is not None:
            centre[:2] = rng.uniform(-0.25, 0.25, 2) * depth
        n, e1, e2 = _basis(normal)
        out.append((centre, n, e1, e2, half,
                    _texture(gen, scene_cfg["texture_size"], device)))
    return out


def _cast(scene, K, E, H, W, device, texel):
    """Per pixel: the camera-space depth of the nearest hit and the
    texture colour there (float64)."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=F64, device=device),
                            torch.arange(W, dtype=F64, device=device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    Kt = torch.as_tensor(K, dtype=F64, device=device)
    R = torch.as_tensor(E[:3, :3], dtype=F64, device=device)
    t = torch.as_tensor(E[:3, 3], dtype=F64, device=device)
    origin = -R.T @ t
    dirs = R.T @ torch.linalg.solve(Kt, pix)              # z_cam = 1 rays
    best = torch.full((H * W,), math.inf, dtype=F64, device=device)
    colour = torch.zeros((H * W, 3), dtype=F64, device=device)
    for centre, n, e1, e2, half, tex in scene:
        nt, c = (torch.as_tensor(a, dtype=F64, device=device)
                 for a in (n, centre))
        lam = ((c - origin) @ nt) / (nt @ dirs)
        pts = origin[:, None] + dirs * lam
        rel = pts - c[:, None]
        u = torch.as_tensor(e1, dtype=F64, device=device) @ rel
        v = torch.as_tensor(e2, dtype=F64, device=device) @ rel
        hit = lam > 0
        if half is not None:
            hit &= (u.abs() < half[0]) & (v.abs() < half[1])
        take = hit & (lam < best)
        best = torch.where(take, lam, best)
        size = tex.shape[0]
        uu = torch.remainder(u / texel, size)
        vv = torch.remainder(v / texel, size)
        u0, v0 = torch.floor(uu), torch.floor(vv)
        fu, fv = (uu - u0)[:, None], (vv - v0)[:, None]
        u0, v0 = u0.long() % size, v0.long() % size
        u1, v1 = (u0 + 1) % size, (v0 + 1) % size
        col = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
               + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)
        colour = torch.where(take[:, None], col, colour)
    return best.reshape(H, W), colour.reshape(H, W, 3)


def render_batch(scene_cfg, B, views, H, W, seed, index, device,
                 with_depth=False):
    """One batch from (seed, index) in the loader's layout, numpy in host
    memory: imgs (B,V,H,W,3) float32, proj_matrices, depth_values (B,Nd);
    with ``with_depth`` also the ground-truth depth and mask at the four
    stages (B,H/8..H,W/8..W)."""
    cams = rig(scene_cfg, views)
    proj = proj_matrices(cams)
    dmin, nd = scene_cfg["depth_min"], scene_cfg["num_depth"]
    interval = scene_cfg["depth_interval"] * scene_cfg["interval_scale"]
    dmax = dmin + interval * nd
    texel = scene_cfg["texel"]
    dv = np.linspace(1.0 / dmax, 1.0 / dmin, nd, dtype=np.float32)
    imgs = np.empty((B, views, H, W, 3), np.float32)
    depth = {f"stage{k}": np.empty((B, H // 2 ** (4 - k), W // 2 ** (4 - k)),
                                   np.float32) for k in range(1, 5)}
    mask = {k: np.empty_like(v) for k, v in depth.items()}
    for b in range(B):
        scene = planes(scene_cfg, [seed, index, b], device)
        for v, (K, E) in enumerate(cams):
            _, col = _cast(scene, K, E, H, W, device, texel)
            imgs[b, v] = (torch.round(col * 255) / 255).float().cpu().numpy()
        if with_depth:
            for k in range(1, 5):
                s = 2 ** (4 - k)
                Ks = cams[0][0].copy()
                Ks[:2] /= s
                z, _ = _cast(scene, Ks, cams[0][1], H // s, W // s, device,
                             texel)
                depth[f"stage{k}"][b] = z.float().cpu().numpy()
                mask[f"stage{k}"][b] = ((z >= dmin) & (z <= dmax)
                                        ).float().cpu().numpy()
    batch = {"imgs": imgs,
             "proj_matrices": {k: np.broadcast_to(m[None], (B,) + m.shape
                                                  ).copy()
                               for k, m in proj.items()},
             "depth_values": np.broadcast_to(dv[None], (B, nd)).copy()}
    if with_depth:
        batch["depth"], batch["mask"] = depth, mask
    return batch
