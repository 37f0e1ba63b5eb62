"""RAFT-style convex upsampling (port of
``effi_mvs_plus_tpu/ops/upsample.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from effi_mvs_plus_tpu_torch.parallel import mesh as par


def convex_upsample(value, mask, ratio):
    """Upsample (B,H,W) -> (B, ratio*H, ratio*W) by a learned convex
    combination over each coarse pixel's 3x3 neighbourhood (zero padded).

    mask: (B, H, W, 9*ratio*ratio) raw logits, channel layout [k, ry, rx]
    with k the neighbourhood index in row-major (dy, dx) order.  Inside
    ``parallel.row_blocks`` under a spatial policy, value and mask are
    this rank's row block, and the row above and below come from the
    neighbouring ranks (zeros past the image's edges).
    """
    B, H, W = value.shape
    r = ratio
    m = torch.softmax(mask.reshape(B, H, W, 9, r, r), dim=3)
    nb = par.run_blocked(_neighbours, value[..., None])       # (B,H,W,9)
    up = torch.einsum("bhwkyx,bhwk->bhwyx", m, nb)            # (B,H,W,r,r)
    return up.permute(0, 1, 3, 2, 4).reshape(B, H * r, W * r)


def _neighbours(v):
    """(B,H,W,1) -> (B,H,W,9): each pixel's 3x3 neighbourhood, zero padded,
    in row-major (dy, dx) order."""
    H, W = v.shape[1:3]
    p = F.pad(v, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=-1)
