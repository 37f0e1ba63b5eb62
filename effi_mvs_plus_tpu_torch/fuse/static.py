"""Static (fixed-threshold) fusion of the Vis-MVSNet lineage, as torch
functions on the device their tensors are on.

Port of ``effi_mvs_plus_tpu/fuse/static.py``.  The inference CLIs use
the dynamic ladder (``fuse/dypcd.py``); this is the fixed-threshold
alternative the upstream code keeps.  Its semantics differ from the
dynamic path's, and are kept exactly:

* pixel grids use +0.5 cell centres;
* every homogeneous normalisation divides by ``last + 1e-9``;
* ``get_reproj`` projects each source pixel (with its own depth) into the
  reference camera, an (x_ref, y_ref, depth_in_ref) field on source
  pixels, and warps that field into reference-pixel alignment through
  the reference depth: normalised coordinates ``coord/size*2-1`` clamped
  to [-1.1, 1.1], sampled with align_corners=True, that is at pixel
  ``(norm+1)/2*(size-1)``;
* ``vis_filter``'s thresholds are reciprocals (dist < 1/img_dist_thresh,
  |Δdepth| < 1/depth_thresh), and the vote is ``sum_views >= vthresh -
  1.1``;
* ``ave_fusion`` averages the passing reprojected depths with the
  reference depth counted once.

The JAX package's ``vmap`` over source views is a batch axis here.
Geometry runs in true fp32 (``device.resolve_device`` turns TF32 off on a
GPU); 3x3 inverses are the closed-form ``core.geometry.inv3x3``, rigid
4x4 inverses ``fuse.dypcd._rigid_inv``, the remap ``ops.warp.
bilinear_gather`` (zeros padding).
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.core.geometry import inv3x3
from effi_mvs_plus_tpu_torch.device import resolve_device
from effi_mvs_plus_tpu_torch.fuse.dypcd import _apply, _rigid_inv
from effi_mvs_plus_tpu_torch.ops.warp import bilinear_gather


def _centered_grid(H, W, device):
    """+0.5 cell-centre pixel grid: x (H,W), y (H,W)."""
    y, x = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    return x, y


def _img2cam(x, y, depth, K_inv):
    """(H,W) centred pixel coordinates and (...,H,W) depths -> (...,H,W,3)
    camera points: the ray normalised by (z + 1e-9), then scaled."""
    pix = torch.stack([x, y, torch.ones_like(x)], -1)
    ray = _apply(K_inv, pix)
    ray = ray / (ray[..., 2:3] + 1e-9)
    return ray * depth[..., None]


def _cam2img(xyz, K):
    """(...,H,W,3) camera points -> centred pixel coordinates, / (z+1e-9)."""
    proj = _apply(K, xyz)
    z = proj[..., 2] + 1e-9
    return proj[..., 0] / z, proj[..., 1] / z


def get_reproj(depth_ref, K_ref, E_ref, depth_srcs, K_srcs, E_srcs):
    """Static reprojection through every source view.

    depth_ref (H,W); depth_srcs (S,H,W); K (3,3) / (S,3,3); E (4,4) /
    (S,4,4).  Returns (reproj_xyd (S,H,W,3), in_range (S,H,W) bool)."""
    resolve_device(depth_ref.device)          # true fp32 on a GPU
    S, H, W = depth_srcs.shape
    xs, ys = _centered_grid(H, W, depth_ref.device)
    src2ref = E_ref @ _rigid_inv(E_srcs)      # world hop composed rigidly
    ref2src = E_srcs @ _rigid_inv(E_ref)

    # the field on source pixels: each source pixel in the ref camera
    xyz_src = _img2cam(xs, ys, depth_srcs, inv3x3(K_srcs))
    xyz_in_ref = (_apply(src2ref[:, :3, :3], xyz_src)
                  + src2ref[:, None, None, :3, 3])
    x_ref, y_ref = _cam2img(xyz_in_ref, K_ref)
    field = torch.stack([x_ref, y_ref, xyz_in_ref[..., 2]], -1)

    # ref pixels -> source coordinates through the ref depth, then the
    # field sampled with the /size*2-1 normalisation
    xyz_ref = _img2cam(xs, ys, depth_ref, inv3x3(K_ref))
    xyz_in_src = (_apply(ref2src[:, :3, :3], xyz_ref)
                  + ref2src[:, None, None, :3, 3])
    wx, wy = _cam2img(xyz_in_src, K_srcs)
    nx = torch.clamp(wx / W * 2.0 - 1.0, -1.1, 1.1)
    ny = torch.clamp(wy / H * 2.0 - 1.0, -1.1, 1.1)
    in_range = (nx >= -1.0) & (nx <= 1.0) & (ny >= -1.0) & (ny <= 1.0)
    px = (nx + 1.0) * 0.5 * (W - 1)            # align_corners=True
    py = (ny + 1.0) * 0.5 * (H - 1)
    warped = bilinear_gather(field, px.reshape(S, -1), py.reshape(S, -1))
    return warped.reshape(S, H, W, 3), in_range


def vis_filter(depth_ref, reproj_xyd, img_dist_thresh, depth_thresh,
               vthresh):
    """Static visibility filter.  reproj_xyd (S,H,W,3).  Returns (per-view
    masks (S,H,W) bool, vote mask (H,W) bool)."""
    x, y = _centered_grid(*depth_ref.shape, depth_ref.device)
    dist = torch.sqrt((reproj_xyd[..., 0] - x) ** 2
                      + (reproj_xyd[..., 1] - y) ** 2)
    ddiff = torch.abs(depth_ref - reproj_xyd[..., 2])
    masks = (dist < 1.0 / img_dist_thresh) & (ddiff < 1.0 / depth_thresh)
    vote = masks.float().sum(0) >= (vthresh - 1.1)
    return masks, vote


def ave_fusion(depth_ref, reproj_xyd, masks):
    """The passing reprojected depths averaged with the reference depth,
    counted once."""
    m = masks.float()
    num = torch.sum(reproj_xyd[..., 2] * m, 0) + depth_ref
    return num / (torch.sum(m, 0) + 1.0)


def prob_filter(conf, prob_thresh, greater=True):
    """Photometric gate: per-stage maps conf (C,H,W) against per-stage
    thresholds (C,), AND-reduced over the stages."""
    thresh = torch.as_tensor(prob_thresh, dtype=torch.float32,
                             device=conf.device).reshape(-1, 1, 1)
    m = conf > thresh if greater else conf < thresh
    return torch.all(m, 0)


def consistency_static(depth_ref, conf_ref, K_ref, E_ref, depth_srcs,
                       K_srcs, E_srcs, prob_thresh=0.8,
                       img_dist_thresh=1.0, depth_thresh=100.0,
                       vthresh=2.0):
    """Static fusion for one reference view: reprojection, visibility
    vote and average, gated by the photometric confidence.  Returns
    (final (H,W) bool, fused (H,W), geo (H,W), photo (H,W)), the contract
    of ``fuse.dypcd.consistency``."""
    reproj_xyd, _ = get_reproj(depth_ref, K_ref, E_ref, depth_srcs, K_srcs,
                               E_srcs)
    masks, geo = vis_filter(depth_ref, reproj_xyd, img_dist_thresh,
                            depth_thresh, vthresh)
    fused = ave_fusion(depth_ref, reproj_xyd, masks)
    photo = conf_ref > prob_thresh
    return photo & geo, fused, geo, photo
