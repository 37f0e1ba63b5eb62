"""The yardstick's arithmetic: the chip's peaks, the least time a piece of
work needs on it, and the bytes and operations of the network's
hand-written kernels (K1 warp + correlation, K2 ConvGRU step, K3 the
warp's backward, K4 the FPN's stem chain) from the configuration's
shapes.  Where the work depends on the data (the source texels a warp
taps), it is counted from the reference's own hypotheses.
"""

from __future__ import annotations

import torch

# published rates of one NVIDIA H100 SXM (data sheet, dense): device
# memory, and FLOP/s outside the tensor cores in fp32 and on them in bf16
MEM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ESIZE = {"float32": 4, "bfloat16": 2}


def bound_s(bytes_, flops, dtype):
    """The least seconds the work needs: bytes over the memory rate or
    operations over the dtype's peak, the larger."""
    return max(bytes_ / MEM_BYTES_S, flops / PEAK_FLOPS[dtype])


def _project(rot, trans, depth):
    B, D, H, W = depth.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=depth.dtype,
                                       device=depth.device),
                          torch.arange(W, dtype=depth.dtype,
                                       device=depth.device), indexing="ij")
    grid = torch.stack([x.reshape(-1), y.reshape(-1),
                        torch.ones(H * W, dtype=depth.dtype,
                                   device=depth.device)])
    xyz = (rot @ grid)[:, :, None] * depth.reshape(B, 1, D, H * W) \
        + trans[:, :, None, None]
    z = torch.where(xyz[:, 2] == 0, xyz[:, 2] + 1e-8, xyz[:, 2])
    return (xyz[:, 0] / z).reshape(B, D, H, W), \
        (xyz[:, 1] / z).reshape(B, D, H, W)


def taps(rots, trans, depth, h, w):
    """(in-image bilinear taps, distinct source texels they reach), over
    every batch row and view: what K3 accumulates and what a warp must
    read of the sources.  rots (B,V,3,3), trans (B,V,3), depth (B,D,H,W);
    sources of h x w."""
    B = depth.shape[0]
    n_taps = n_texels = 0
    b = torch.arange(B, device=depth.device).view(B, 1, 1, 1)
    for v in range(rots.shape[1]):
        px, py = _project(rots[:, v], trans[:, v], depth)
        x0, y0 = torch.floor(px), torch.floor(py)
        hit = torch.zeros(B * h * w, dtype=torch.bool, device=depth.device)
        for oy in (0, 1):
            for ox in (0, 1):
                x, y = x0 + ox, y0 + oy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                n_taps += int(ok.sum())
                flat = (b * h + y.clamp(0, h - 1).long()) * w \
                    + x.clamp(0, w - 1).long()
                hit[flat[ok]] = True
        n_texels += int(hit.sum())
    return n_taps, n_texels


def k1_work(B, V, D, h, w, C, texels, dtype, per_pixel_depth):
    """K1: reads the reference features, the tapped source texels, the
    hypotheses (a vector a row for the stage-1 sweep, per pixel after)
    and the projections; writes (B,V,D,h,w).  Per output: 4 taps of 2
    operations a channel, the product and the sum (10 C), and the
    projection and weights (16)."""
    esz = ESIZE[dtype]
    n_out = B * V * D * h * w
    depth_bytes = B * D * (h * w if per_pixel_depth else 1) * 4
    bytes_ = (B * h * w * C + texels * C + n_out) * esz + depth_bytes \
        + B * V * 12 * 4
    return bytes_, n_out * (10 * C + 16)


def k3_work(B, V, D, h, w, C, n_taps, texels, dtype, per_pixel_depth):
    """K3: reads the reference features, the tapped source texels and the
    output gradient; writes d_ref and the whole d_src.  Per output 20
    operations, per tap 4 a channel."""
    esz = ESIZE[dtype]
    n_g = B * V * D * h * w
    depth_bytes = B * D * (h * w if per_pixel_depth else 1) * 4
    bytes_ = (2 * B * h * w * C + texels * C + B * V * h * w * C + n_g) \
        * esz + depth_bytes + B * V * 12 * 4
    return bytes_, 20 * n_g + 4 * C * n_taps


def k2_work(B, h, w, hd, dtype):
    """K2: reads h and x, writes h'; three 3x3 gates over 2 hd inputs."""
    npx = B * h * w
    bytes_ = 3 * npx * hd * ESIZE[dtype] + (9 * 2 * hd * 3 * hd + 3 * hd) * 4
    return bytes_, 108 * hd * hd * npx


def k4_work(npx, chans, dtype):
    """K4: a chain of 3x3 conv + BN + ReLU layers on npx pixels, channels
    chans[0] -> ... -> chans[-1]: reads the input, writes the output."""
    flops = 18 * npx * sum(a * b for a, b in zip(chans[:-1], chans[1:]))
    weights = sum(9 * a * b + b for a, b in zip(chans[:-1], chans[1:])) * 4
    return npx * (chans[0] + chans[-1]) * ESIZE[dtype] + weights, flops


def stage_shape(H, W, s):
    """(h, w) of stage s (0-based): 1/8, 1/4, 1/2 of the input."""
    return H // 2 ** (3 - s), W // 2 ** (3 - s)


def k2_launches(model, B, H, W, dtype):
    """[(bytes, flops)] of a forward's K2 launches: gru_iters a stage."""
    out = []
    for s, hd in enumerate(model["hdim"]):
        h, w = stage_shape(H, W, s)
        out += [k2_work(B, h, w, hd, dtype)] * model["gru_iters"][s]
    return out


def k4_launches(model, B, V, H, W, dtype):
    """[(bytes, flops)] of an inference forward's K4 launches: every FPN
    level's stride-1 run (the feature net on B*V images, the context net
    on B)."""
    out = []
    for n_img, chans in ((B * V, model["feature_channels"]),
                         (B, model["context_channels"])):
        for i, c in enumerate(chans):
            npx = n_img * (H // 2 ** i) * (W // 2 ** i)
            out.append(k4_work(npx, (3, c, c) if i == 0 else (c, c, c),
                               dtype))
    return out


def warp_launches(warps, dtype, backward=False):
    """[(bytes, flops)] of K1 (or, with ``backward``, K3) from the
    reference's recorded warp calls (``Counter.warps``)."""
    out = []
    for rec in warps:
        B, V = rec["rot"].shape[:2]
        D, h, w = rec["depth"].shape[1:]
        n_taps, texels = taps(rec["rot"], rec["trans"], rec["depth"],
                              rec["h"], rec["w"])
        per_pixel = rec["stage"] > 0
        if backward:
            out.append(k3_work(B, V, D, h, w, rec["C"], n_taps, texels,
                               dtype, per_pixel))
        else:
            out.append(k1_work(B, V, D, h, w, rec["C"], texels, dtype,
                               per_pixel))
    return out
