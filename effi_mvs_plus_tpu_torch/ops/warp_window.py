"""The decomposition of the warp + correlation kernels K1 and K3
(``csrc/warp_window.cuh``) in plain PyTorch, for the CPU tests.

A block owns a TILE_H x TILE_W tile of ref pixels of one (batch, view)
and a chunk of hypotheses; its window is the bounding box of the chunk's
taps (K3: of every tap; K1: of each ray's first and last hypothesis),
clipped to the budget of ``cuda_warp.window_plan``.  ``window_correlate``
and ``window_correlate_bwd`` read a tap from a copy of its block's window
where it falls in it and from the source map where it does not, and K3's
d_ref is summed over per-view partials in order, as the kernels do.  This
models the decomposition, not the kernels' code: the card tests
(tests/test_torch_kernels_cuda.py) hold the kernels themselves.
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.core import geometry
from effi_mvs_plus_tpu_torch.ops.cuda_warp import TILE_H, TILE_W, window_plan


def _taps(rots, transs, depth, H, W):
    """The taps of ``taps_at`` (csrc/warp_project.cuh) at every (b, v, d,
    y, x), from the plain version's projection: the coordinates px, py;
    the corner (x0, y0) of the 2x2 square (int64, 0 where no tap is in the
    image); the weights (..., 4) and validity (..., 4) of the taps
    (x0,y0), (x1,y0), (x0,y1), (x1,y1); and whether any is valid."""
    B, V = rots.shape[:2]
    D = depth.shape[1]
    px, py = geometry.project_to_src(
        rots.reshape(B * V, 3, 3), transs.reshape(B * V, 3),
        depth[:, None].expand(B, V, D, H, W).reshape(B * V, D, H, W), H, W)
    px, py = px.reshape(B, V, D, H, W), py.reshape(B, V, D, H, W)
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = px - x0f, py - y0f
    vx = [(x0f + o >= 0) & (x0f + o < W) for o in (0, 1)]
    vy = [(y0f + o >= 0) & (y0f + o < H) for o in (0, 1)]
    w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                     wx * wy], -1)
    valid = torch.stack([vx[0] & vy[0], vx[1] & vy[0], vx[0] & vy[1],
                         vx[1] & vy[1]], -1)
    anyv = (vx[0] | vx[1]) & (vy[0] | vy[1])
    x0 = torch.where(anyv, x0f, 0.0).long()
    y0 = torch.where(anyv, y0f, 0.0).long()
    return px, py, x0, y0, w, valid, anyv


def _span_boxes(px, py, H, W, dc):
    """``box_add_span`` (K1): for each (b, v, chunk, y, x), the box of the
    squares of the chunk's first and last hypothesis, clamped to the
    image in floats; (x0, y0, x1, y1) int64 and whether it meets the
    image."""
    D = px.shape[2]
    first = torch.arange(0, D, dc)
    last = torch.clamp(first + dc, max=D) - 1
    ends = [(torch.floor(t[:, :, first]), torch.floor(t[:, :, last]))
            for t in (px, py)]
    x0, x1 = torch.fmin(*ends[0]), torch.fmax(*ends[0]) + 1
    y0, y1 = torch.fmin(*ends[1]), torch.fmax(*ends[1]) + 1
    meets = (x1 >= 0) & (x0 <= W - 1) & (y1 >= 0) & (y0 <= H - 1)
    return (x0.clamp(min=0).long(), y0.clamp(min=0).long(),
            x1.clamp(max=W - 1).long(), y1.clamp(max=H - 1).long(), meets)


def _blocks(B, V, N, H, W, per):
    """The block (b, v, tile row, tile column, chunk), flat, of each entry
    of a (B, V, N, H, W) tensor whose third axis holds ``per`` entries a
    chunk, and the number of blocks."""
    nty, ntx, nch = -(-H // TILE_H), -(-W // TILE_W), -(-N // per)
    b, v, n, y, x = torch.meshgrid(
        *(torch.arange(k) for k in (B, V, N, H, W)), indexing="ij")
    blk = (((b * V + v) * nty + y // TILE_H) * ntx + x // TILE_W) * nch \
        + n // per
    return blk.reshape(-1), B * V * nty * ntx * nch


def _windows(boxes, blk, nblk, cap):
    """``block_window``: each block's window origin, width and height
    (int64; 0 x 0 where no tap is in the image, or for a budget of 0) from
    boxes (x0, y0, x1, y1, in image) and the block of each box."""
    a = boxes[4].reshape(-1)

    def reduce(vals, fill, how):
        return torch.full((nblk,), fill, dtype=torch.long).scatter_reduce(
            0, blk, torch.where(a, vals.reshape(-1), fill), how)
    big = 2 ** 31
    bx0, by0 = reduce(boxes[0], big, "amin"), reduce(boxes[1], big, "amin")
    bx1, by1 = reduce(boxes[2], -1, "amax"), reduce(boxes[3], -1, "amax")
    empty = (bx1 < bx0) | (cap == 0)
    bw, bh = bx1 - bx0 + 1, by1 - by0 + 1
    s = torch.sqrt(torch.tensor(float(cap)) / (bw * bh).float())
    over = bw * bh > cap
    ww = torch.where(over, torch.minimum(bw, (bw.float() * s).long())
                     .clamp(min=1), bw)
    wh = torch.where(over, torch.minimum(bh, cap // ww).clamp(min=1), bh)
    zero = torch.zeros_like(bw)
    return (torch.where(empty, zero, bx0 + (bw - ww) // 2),
            torch.where(empty, zero, by0 + (bh - wh) // 2),
            torch.where(empty, zero, ww), torch.where(empty, zero, wh))


def _decompose(src, rots, transs, depth, dc, cap, span):
    """The taps of every (b, v, d, y, x) and where each is served from,
    with K1's windows (``span``: from the chunks' end hypotheses) or K3's
    (from every tap): (weights (N, 4), validity (N, 4), for each tap its
    row in the staged windows (-1 outside) and in ``src`` flattened to
    (B*V*H*W, C), and the window texels' rows in that flat ``src``)."""
    B, V, H, W, C = src.shape
    D = depth.shape[1]
    px, py, x0, y0, w, valid, anyv = _taps(rots, transs, depth, H, W)
    blk, nblk = _blocks(B, V, D, H, W, dc)
    if span:
        boxes = _span_boxes(px, py, H, W, dc)
        box_blk = _blocks(B, V, -(-D // dc), H, W, 1)[0]
    else:
        boxes = (x0.clamp(min=0), y0.clamp(min=0), (x0 + 1).clamp(max=W - 1),
                 (y0 + 1).clamp(max=H - 1), anyv)
        box_blk = blk
    wx0, wy0, ww, wh = _windows(boxes, box_blk, nblk, cap)
    sizes = ww * wh
    start = torch.cumsum(sizes, 0) - sizes
    bv = torch.arange(B * V).repeat_interleave(blk.numel() // (B * V))
    # the staged texels, block by block, row-major in each window
    tb = torch.repeat_interleave(torch.arange(nblk), sizes)
    local = torch.arange(tb.numel()) - start[tb]
    staged_rows = (tb // (nblk // (B * V))) * H * W \
        + (wy0[tb] + local // ww[tb]) * W + wx0[tb] + local % ww[tb]
    x0, y0 = x0.reshape(-1), y0.reshape(-1)
    win_rows, src_rows = [], []
    for k in range(4):
        tx, ty = x0 + (k & 1), y0 + (k >> 1)
        lx, ly = tx - wx0[blk], ty - wy0[blk]
        ok = valid.reshape(-1, 4)[:, k]
        inw = ok & (lx >= 0) & (lx < ww[blk]) & (ly >= 0) & (ly < wh[blk])
        win_rows.append(torch.where(inw, start[blk] + ly * ww[blk] + lx, -1))
        src_rows.append(torch.where(ok, bv * H * W + ty * W + tx, -1))
    return (w.reshape(-1, 4), valid.reshape(-1, 4),
            torch.stack(win_rows, -1), torch.stack(src_rows, -1),
            staged_rows)


def window_correlate(ref_fea, src_feas, rots, transs, depth, cap=None):
    """K1's decomposition in plain PyTorch, fp32: the taps of each block
    and chunk read from a copy of its window where they fall in it and
    from ``src_feas`` where they do not.  Arguments as
    ``warp_correlate_views``; ``cap`` overrides the window budget in
    texels.  On the CPU.  Returns (corr (B,V,D,H,W) fp32, {"window": taps
    read from a window, "device": taps read from device memory})."""
    B, H, W, C = ref_fea.shape
    V, D = src_feas.shape[1], depth.shape[1]
    dc, cap0 = window_plan("fwd", C, ref_fea.dtype, D)
    w, valid, win_rows, src_rows, staged_rows = _decompose(
        src_feas, rots, transs, depth, dc, cap0 if cap is None else cap,
        span=True)
    flat = src_feas.float().reshape(-1, C)
    staged = flat[staged_rows]
    samp = torch.zeros((w.shape[0], C), dtype=torch.float32)
    for k in range(4):
        inw = win_rows[:, k] >= 0
        outw = valid[:, k] & ~inw
        tap = torch.zeros_like(samp)
        tap[inw] = staged[win_rows[inw, k]]
        tap[outw] = flat[src_rows[outw, k]]
        samp = samp + tap * w[:, k, None]
    ref = ref_fea.float()[:, None, None].expand(B, V, D, H, W, C)
    corr = (samp * ref.reshape(-1, C)).sum(-1) / C
    inw = win_rows >= 0
    return corr.reshape(B, V, D, H, W), {
        "window": int(inw.sum()), "device": int((valid & ~inw).sum())}


def window_correlate_bwd(ref_fea, src_feas, rots, transs, depth, g,
                         cap=None):
    """K3's decomposition in plain PyTorch, fp32: d_ref as per-view
    partials summed over the views in order; d_src accumulated in each
    block's window for the taps inside it, added to d_src directly for
    the taps outside, and the windows then added to d_src.  ``cap`` as
    for ``window_correlate``; on the CPU.  Returns (d_ref (B,H,W,C), d_src
    (B,V,H,W,C), {"window": adds of a tap into a window, "device": adds
    of a tap into d_src directly, "flush": adds of the windows' flush,
    nonzero float4s x 4}).  (The kernel first sums a run of hypotheses on
    one square in registers, so it makes fewer adds than taps.)"""
    B, H, W, C = ref_fea.shape
    V, D = src_feas.shape[1], depth.shape[1]
    dc, cap0 = window_plan("bwd", C, ref_fea.dtype, D)
    w, valid, win_rows, src_rows, staged_rows = _decompose(
        src_feas, rots, transs, depth, dc, cap0 if cap is None else cap,
        span=False)
    flat = src_feas.float().reshape(-1, C)
    ref = ref_fea.float()[:, None, None].expand(B, V, D, H, W, C) \
        .reshape(-1, C)
    gd = g.float().reshape(-1) / C
    part = torch.zeros((w.shape[0], C), dtype=torch.float32)
    window = torch.zeros((staged_rows.numel(), C), dtype=torch.float32)
    d_src = torch.zeros_like(flat)
    for k in range(4):
        ok = valid[:, k]
        inw = win_rows[:, k] >= 0
        outw = ok & ~inw
        gw = torch.where(ok, gd * w[:, k], 0.0)[:, None]
        tap = torch.zeros_like(part)
        tap[ok] = flat[src_rows[ok, k]]
        part = part + gw * tap
        add = gw * ref
        window.index_add_(0, win_rows[inw, k], add[inw])
        d_src.index_add_(0, src_rows[outw, k], add[outw])
    flushed = (window.reshape(-1, 4) != 0).any(-1)
    d_src.index_add_(0, staged_rows, window)
    part = part.reshape(B, V, D, H, W, C).sum(2)
    d_ref = part[:, 0]
    for v in range(1, V):
        d_ref = d_ref + part[:, v]
    inw = win_rows >= 0
    return d_ref, d_src.reshape(B, V, H, W, C), {
        "window": int(inw.sum()) * C,
        "device": int((valid & ~inw).sum()) * C,
        "flush": int(flushed.sum()) * 4}
