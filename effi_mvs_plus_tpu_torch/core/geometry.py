"""Camera geometry core: projection composition, inverse-depth sampling,
disparity<->depth maps.

Port of ``effi_mvs_plus_tpu/core/geometry.py``; same conventions:

* ``proj`` tensors are per view a (2,4,4) stack — slot 0 the 4x4
  extrinsics (world->cam), slot 1 the intrinsics K in the top-left 3x3
  block, pre-scaled per pyramid stage.
* "disp" means *normalised inverse depth* in [0,1]:
  ``disp = (1/depth - 1/max) / (1/min - 1/max)``.

Everything here is true fp32.  Pixel coordinates reach 1920 and focal
lengths ~2227, so a reduced-precision product (bf16 or TF32 operands)
quantises the projected warp coordinates to multi-pixel granularity — the
source of a ~40 mm systematic depth bias at metric scale.  The products
are einsums on small tensors; on CUDA ``device.resolve_device`` turns
TF32 off for matmuls and convolutions alike.
"""

from __future__ import annotations

import torch


def compose_projection(proj_2x4x4):
    """K·[R|t] composed into one 4x4: rows 0-2 of the extrinsics
    premultiplied by K[:3,:3]; row 3 kept from the extrinsics.

    proj_2x4x4: (..., 2, 4, 4) -> (..., 4, 4)
    """
    ext = proj_2x4x4[..., 0, :, :]
    K = proj_2x4x4[..., 1, :3, :3]
    top = torch.einsum("...ij,...jk->...ik", K, ext[..., :3, :4])
    return torch.cat([top, ext[..., 3:4, :]], dim=-2)


def inv3x3(m):
    """Closed-form adjugate inverse of (...,3,3).  Exact to fp32 rounding
    for the well-conditioned K·[R|t] blocks; an LU inverse loses digits
    that sub-pixel warp parity needs, so ``torch.linalg.inv`` is not
    used."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def relative_projection(src_proj, ref_proj):
    """rot, trans mapping ref-camera pixel rays to src pixels:
    rot = M_src @ M_ref^-1, trans = t_src - rot @ t_ref (projection
    matrices with bottom row (0,0,0,1)).  Returns (rot (...,3,3),
    trans (...,3))."""
    m_src, t_src = src_proj[..., :3, :3], src_proj[..., :3, 3]
    m_ref, t_ref = ref_proj[..., :3, :3], ref_proj[..., :3, 3]
    rot = torch.einsum("...ij,...jk->...ik", m_src, inv3x3(m_ref))
    trans = t_src - torch.einsum("...ij,...j->...i", rot, t_ref)
    return rot, trans


def disp_to_depth(disp, min_depth, max_depth):
    """Normalised disparity in [0,1] -> (scaled_disp, depth); scaled_disp
    is clamped at 1e-4."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    scaled = torch.clamp(scaled, min=1e-4)
    return scaled, 1.0 / scaled


def depth_to_disp(depth, min_depth, max_depth):
    """depth -> normalised disparity (the 1e-10 keeps a zero range
    finite)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / ((max_disp - min_disp) + 1e-10)


def depth_range_samples_global(depth_values, ndepth, height, width):
    """Uniform sweep over the global range: linspace from
    depth_values[:,0] to depth_values[:,-1] with ndepth points, broadcast
    (as an expanded view) to (B,D,H,W)."""
    lo = depth_values[:, 0]
    hi = depth_values[:, -1]
    step = (hi - lo) / (ndepth - 1)
    idx = torch.arange(ndepth, dtype=depth_values.dtype,
                       device=depth_values.device)
    d = lo[:, None] + idx[None, :] * step[:, None]
    return d[:, :, None, None].expand(depth_values.shape[0], ndepth,
                                      height, width)


def depth_range_samples_local(cur_depth, ndepth, interval):
    """Per-pixel sweep around the current estimate: ndepth samples from
    clamp(cur - (n//2)*interval) to clamp(cur + (n//2)*interval), final
    clamp at 1e-5.

    cur_depth: (B,H,W); interval: broadcastable to (B,H,W).
    Returns (B,D,H,W).
    """
    half = ndepth // 2
    lo = torch.clamp(cur_depth - half * interval, min=1e-4)
    hi = torch.clamp(cur_depth + half * interval, 1e-4, 1e4)
    step = (hi - lo) / (ndepth - 1)
    idx = torch.arange(ndepth, dtype=cur_depth.dtype,
                       device=cur_depth.device)[None, :, None, None]
    samples = lo[:, None] + idx * step[:, None]
    return torch.clamp(samples, min=1e-5)


def pixel_grid(height, width, dtype=torch.float32, device=None, y0=0):
    """Homogeneous pixel grid (3, H*W): rows (x, y, 1), y from ``y0``."""
    y, x = torch.meshgrid(torch.arange(y0, y0 + height, dtype=dtype,
                                       device=device),
                          torch.arange(width, dtype=dtype, device=device),
                          indexing="ij")
    x = x.reshape(-1)
    y = y.reshape(-1)
    return torch.stack([x, y, torch.ones_like(x)], dim=0)


def project_to_src(rot, trans, depth, height, width, y0=0):
    """Project the ref pixel grid at per-pixel depths into a source view.

    rot: (B,3,3); trans: (B,3); depth: (B,D,H,W) actual depths of ref
    rows y0 .. y0 + H - 1.
    Returns px, py: (B,D,H,W) source-view pixel coordinates, with the
    reference's z==0 -> z+1e-8 guard.
    """
    B, D, H, W = depth.shape
    grid = pixel_grid(height, width, depth.dtype, depth.device, y0)
    ray = torch.einsum("bij,jp->bip", rot, grid)                  # (B,3,HW)
    xyz = (ray[:, :, None, :] * depth.reshape(B, 1, D, H * W)
           + trans[:, :, None, None])                             # (B,3,D,HW)
    z = xyz[:, 2]
    z = torch.where(z == 0, z + 1e-8, z)
    px = xyz[:, 0] / z
    py = xyz[:, 1] / z
    return px.reshape(B, D, H, W), py.reshape(B, D, H, W)
