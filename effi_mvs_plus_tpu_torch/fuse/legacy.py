"""The legacy 3-D-distance fusion tail of the Vis-MVSNet lineage, as torch
functions on the device their tensors are on.

Port of ``effi_mvs_plus_tpu/fuse/legacy.py``: ``homo_warping``,
``generate_points_from_depth`` and the 3-D-distance ``filter_depth``,
part of the upstream module's API though the inference CLIs use the
dynamic ladder (``fuse/dypcd.py``).  Their semantics differ from both
other fusion paths, and are kept exactly, quirks included:

* pixel grids are plain integer ``arange`` (no +0.5 cell centres);
* homogeneous division is a bare ``/ z`` (no 1e-9 guard);
* ``homo_warping`` normalises coordinates with the align_corners=True
  formula ``x / ((W-1)/2) - 1`` but samples with align_corners=False,
  at pixel ``((nx+1)*W - 1)/2``: a half-pixel-class skew reproduced, not
  fixed;
* ``filter_depth`` composes P = K·E per view, inverts the full 4x4
  (``torch.linalg.inv``, as the JAX package's ``jnp.linalg.inv``), and
  measures the per-pixel distance between the reference back-projection
  and each source back-projection warped into reference alignment.

Shapes are channels-last and unbatched, as the JAX package's: depth
(H, W), features (H, W, C), projections (4, 4) or stacked (2, 4, 4)
extrinsics and intrinsics.  Geometry runs in true fp32
(``device.resolve_device`` turns TF32 off on a GPU).
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.device import resolve_device
from effi_mvs_plus_tpu_torch.fuse.dypcd import _apply, _pixel_xy
from effi_mvs_plus_tpu_torch.ops.warp import bilinear_gather


def compose_proj(proj):
    """(..., 2, 4, 4) stacked [extrinsics, intrinsics] -> (..., 4, 4)
    P = K·E with E's last row; any other input is returned as it is (so,
    as in the JAX package, a stack of two composed 4x4 is read as one
    stacked pair)."""
    proj = torch.as_tensor(proj, dtype=torch.float32)
    if proj.dim() >= 3 and proj.shape[-3] == 2:
        E, K = proj[..., 0, :, :], proj[..., 1, :, :]
        top = K[..., :3, :3] @ E[..., :3, :4]
        return torch.cat([top, E[..., 3:4, :]], -2)
    return proj


def _pixels(H, W, device):
    """(H,W,3) homogeneous integer pixel coordinates (x, y, 1)."""
    x, y = _pixel_xy(H, W, device)
    return torch.stack([x, y, torch.ones_like(x)], -1)


def generate_points_from_depth(depth, proj):
    """World points (H,W,3) of a depth map (H,W) back-projected through
    the inverse of a composed (4,4) projection (or a (2,4,4) stack,
    composed here)."""
    resolve_device(depth.device)              # true fp32 on a GPU
    inv = torch.linalg.inv(compose_proj(proj).to(depth.device))
    H, W = depth.shape
    ray = _apply(inv[:3, :3], _pixels(H, W, depth.device))
    return ray * depth[..., None] + inv[:3, 3]


def homo_warping(src_fea, src_proj, ref_proj, depth):
    """Single-depth homography warp of a source map (H,W,C) into reference
    alignment through the reference depth (H,W); src_proj and ref_proj
    composed (4,4).  Returns (H,W,C), zeros where a tap leaves the map."""
    resolve_device(src_fea.device)
    H, W, _ = src_fea.shape
    proj = src_proj @ torch.linalg.inv(ref_proj)
    xyz = (_apply(proj[:3, :3], _pixels(H, W, src_fea.device))
           * depth[..., None] + proj[:3, 3])
    nx = xyz[..., 0] / xyz[..., 2] / ((W - 1) / 2.0) - 1.0
    ny = xyz[..., 1] / xyz[..., 2] / ((H - 1) / 2.0) - 1.0
    # sampled as grid_sample's default align_corners=False maps them
    px = ((nx + 1.0) * W - 1.0) * 0.5
    py = ((ny + 1.0) * H - 1.0) * 0.5
    out = bilinear_gather(src_fea[None], px.reshape(1, -1),
                          py.reshape(1, -1))
    return out.reshape(H, W, -1)


def filter_depth(ref_depth, src_depths, ref_proj, src_projs):
    """The 3-D-distance consistency field.

    ref_depth (H,W); src_depths (V,H,W); ref_proj (2,4,4) or (4,4);
    src_projs (V,2,4,4) or (V,4,4).  Returns (ref_pc (H,W,3), aligned_pcs
    (V,H,W,3), dist (V,H,W)): each source view's back-projected cloud
    warped into reference alignment, and its distance to the reference
    cloud."""
    ref_P = compose_proj(ref_proj).to(ref_depth.device)
    src_Ps = compose_proj(src_projs).to(ref_depth.device)
    ref_pc = generate_points_from_depth(ref_depth, ref_P)
    aligned = torch.stack([
        homo_warping(generate_points_from_depth(d, P), P, ref_P, ref_depth)
        for d, P in zip(src_depths, src_Ps)])
    dist = torch.sqrt(torch.sum((ref_pc[None] - aligned) ** 2, -1))
    return ref_pc, aligned, dist
