"""Homography warp + group correlation, plain PyTorch.

Port of ``effi_mvs_plus_tpu/ops/warp.py``.  Bilinear sampling follows
``F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True)`` exactly, written out so the semantics are explicit:

* ``align_corners=True`` — sampling happens directly in pixel coordinates;
* ``padding_mode='zeros'`` — each of the four taps contributes 0 when its
  integer coordinate falls outside the image; weights are NOT
  renormalised.

This is the plain version the CUDA kernel of ``ops/cuda_warp.py`` is
held against, and the CPU path.
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.core import geometry


def bilinear_gather(fea, px, py):
    """fea: (B, H, W, C); px, py: (B, N) pixel coordinates.
    Returns (B, N, C) in fea's dtype."""
    B, H, W, C = fea.shape
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    wx = (px - x0f).to(fea.dtype)
    wy = (py - y0f).to(fea.dtype)
    flat = fea.reshape(B, H * W, C)

    def tap(xf, yf):
        # bounds tested on the float coordinates: an int cast of a far
        # off-image coordinate could overflow
        inb = (xf >= 0) & (xf < W) & (yf >= 0) & (yf < H)
        idx = torch.where(inb, yf * W + xf, torch.zeros_like(xf)).long()
        v = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        return torch.where(inb[..., None], v, torch.zeros((), dtype=v.dtype,
                                                          device=v.device))

    w00 = ((1 - wx) * (1 - wy))[..., None]
    w01 = (wx * (1 - wy))[..., None]
    w10 = ((1 - wx) * wy)[..., None]
    w11 = (wx * wy)[..., None]
    out = (tap(x0f, y0f) * w00 + tap(x0f + 1, y0f) * w01
           + tap(x0f, y0f + 1) * w10 + tap(x0f + 1, y0f + 1) * w11)
    return out.to(fea.dtype)


def homo_warp(src_fea, rot, trans, depth, y0=0):
    """src_fea: (B, Hs, W, C); rot: (B,3,3); trans: (B,3);
    depth: (B, D, H, W) actual depths of ref rows y0 .. y0 + H - 1 (all
    of them: y0 = 0, H = Hs).  Returns (B, D, H, W, C)."""
    B, _, W, C = src_fea.shape
    D, H = depth.shape[1], depth.shape[2]
    px, py = geometry.project_to_src(rot, trans, depth, H, W, y0)
    out = bilinear_gather(src_fea, px.reshape(B, -1), py.reshape(B, -1))
    return out.reshape(B, D, H, W, C)


def warp_correlate(ref_fea, src_fea, rot, trans, depth, groups=1, y0=0):
    """Mean over channels-per-group of (warped_src * ref) at every depth
    hypothesis.  ref_fea: (B, H, W, C) rows y0 .. y0 + H - 1 of the
    reference; src_fea: (B, Hs, W, C) the whole source; depth:
    (B, D, H, W).  Returns (B, D, H, W, G)."""
    B, H, W, C = ref_fea.shape
    D = depth.shape[1]
    warped = homo_warp(src_fea, rot, trans, depth, y0)     # (B,D,H,W,C)
    w = warped.reshape(B, D, H, W, groups, C // groups)
    r = ref_fea.reshape(B, 1, H, W, groups, C // groups)
    return torch.mean(w * r, dim=-1)
