"""Plane-sweep warp + correlation over all source views (kernel K1) and
its backward (kernel K3).

Port of ``effi_mvs_plus_tpu/ops/pallas_warp.py::warp_correlate_views_fused``
and its custom VJP.  A CUDA tensor goes through ``_WarpCorrelate``, an
autograd Function whose forward launches the hand-written kernel of
``csrc/warp_correlate.cu`` and whose backward launches that of
``csrc/warp_correlate_bwd.cu``; a CPU tensor takes the plain version
``_views_torch`` (the counterpart of ``pallas_warp._views_xla``), which
autograd differentiates as ``jax.vjp(_views_xla)`` does.  Either way the
result is cast to the features' dtype, as on the TPU path.  Gradients flow
to the ref and source features only: rotations, translations and depths
get none (``_views_bwd`` returns None for them), and the depths that reach
the warp are already detached.

The TPU kernel copies a static window of the source map into VMEM and so
drops taps that fall outside it; its region window, rung ladder, fit
predicates, overflow patch and XLA demotion exist for that alone.  The
CUDA kernels (``csrc/warp_window.cuh``) take each block's window from
its own taps, a tile of ref pixels by a chunk of hypotheses, and serve a
tap outside a clipped window from device memory, which is exact, so there
is one path.  ``window_plan`` sizes the chunks and windows of both
launches; ``ops/warp_window.py`` emulates that decomposition in plain
PyTorch for the CPU tests.
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch.ops import _kernels, warp

_CHANNELS = (8, 16, 32)

# The kernels' decomposition (csrc/warp_window.cuh): a block owns a
# TILE_H x TILE_W tile of ref pixels of one (batch, view) and walks the
# hypotheses a chunk at a time, each chunk through a window of the source
# map in shared memory: the bounding box of the chunk's taps, clipped to
# the window budget.  K1 takes K1_CHUNK hypotheses a chunk and
# double-buffers two windows of K1_WINDOW_TEXELS where the sweep takes
# more than one chunk and texels have 64 bytes or more (the stage-1
# sweep); elsewhere it reads every tap from device memory, where a gather
# costs less than staging (``window_plan``).
# K3 takes K3_CHUNK (at most MAX_CHUNK in csrc/warp_window.cuh) and
# accumulates d_src in one fp32 window of K3_WINDOW_TEXELS beside its
# records of 24 bytes a (pixel, hypothesis).
TILE_H, TILE_W = 8, 16
K1_CHUNK, K3_CHUNK = 16, 8
K1_WINDOW_TEXELS = 256
K3_WINDOW_TEXELS = 256


def _window_stride(C, esz):
    """K1's texel stride in shared memory, in elements: an odd number of
    16-byte units (``window_stride`` in csrc/warp_correlate.cu)."""
    return ((C * esz // 16) | 1) * (16 // esz)


def window_plan(kernel, C, dtype, D):
    """(hypotheses a chunk, texels a window) of a K1 (``"fwd"``) or K3
    (``"bwd"``) launch at D hypotheses on features of C channels and
    ``dtype``."""
    if kernel == "fwd":
        esz = torch.empty((), dtype=dtype).element_size()
        windows = D > K1_CHUNK and C * esz >= 64
        return min(D, K1_CHUNK), K1_WINDOW_TEXELS if windows else 0
    if kernel == "bwd":
        return min(D, K3_CHUNK), K3_WINDOW_TEXELS
    raise ValueError(f"unknown kernel {kernel!r}")


def _views_torch(ref_fea, src_feas, rots, transs, depth, y0=0):
    """Plain PyTorch version: one ``warp.warp_correlate`` per source view.
    ref_fea (B,H,W,C) rows y0 .. y0 + H - 1 of the reference, src_feas
    (B,V,Hs,W,C), rots (B,V,3,3), transs (B,V,3), depth (B,D,H,W) ->
    (B,V,D,H,W)."""
    V = src_feas.shape[1]
    return torch.stack(
        [warp.warp_correlate(ref_fea, src_feas[:, v], rots[:, v],
                             transs[:, v], depth, 1, y0)[..., 0]
         for v in range(V)], dim=1)


def _check_inputs(ref_fea, src_feas, rots, transs, depth, y0):
    """Raise on what the kernels do not take; returns rots and transs as
    the contiguous fp32 tensors the kernels read."""
    B, H, W, C = ref_fea.shape
    V, Hs = src_feas.shape[1], src_feas.shape[2]
    D = depth.shape[1]
    dev = ref_fea.device
    _kernels.check_dtype(ref_fea=ref_fea, src_feas=src_feas)
    if C not in _CHANNELS:
        raise ValueError(f"channels must be one of {_CHANNELS}, got {C}")
    if tuple(src_feas.shape) != (B, V, Hs, W, C) or not (
            0 <= y0 and y0 + H <= Hs):
        raise ValueError(f"src_feas {tuple(src_feas.shape)} does not hold "
                         f"rows {y0} .. {y0 + H - 1} of ref_fea "
                         f"{tuple(ref_fea.shape)}")
    if tuple(depth.shape) != (B, D, H, W) or depth.dtype != torch.float32:
        raise ValueError(f"depth must be float32 (B,D,H,W)=({B},D,{H},{W}), "
                         f"got {depth.dtype} {tuple(depth.shape)}")
    if tuple(rots.shape) != (B, V, 3, 3) or tuple(transs.shape) != (B, V, 3):
        raise ValueError("rots/transs must be (B,V,3,3)/(B,V,3)")
    for name, t in (("src_feas", src_feas), ("depth", depth), ("rots", rots),
                    ("transs", transs)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ref_fea on {dev}")
    if Hs >= 2 ** 15 or W >= 2 ** 15:
        raise ValueError(f"maps must be under 32768 a side, got {Hs}x{W}")
    # each batch item's map dense and 16-byte aligned
    _kernels.check_dense(3, ref_fea=ref_fea)
    _kernels.check_dense(4, src_feas=src_feas)
    return (rots.to(torch.float32).contiguous(),
            transs.to(torch.float32).contiguous())


def _stats_ptr(stats, n, dev):
    """The device address of a counter tensor of n int64 for a kernel to
    add to, or None."""
    if stats is None:
        return None
    if stats.dtype != torch.int64 or stats.numel() != n \
            or stats.device != dev or not stats.is_contiguous():
        raise ValueError(f"stats must be {n} contiguous int64 on {dev}")
    return stats.data_ptr()


def _views_cuda(ref_fea, src_feas, rots, transs, depth, stats=None, y0=0):
    """K1 on ref rows y0 .. y0 + H - 1 against the whole source maps.
    ``stats``, an int64 tensor of 2 on the card, gains the taps read from
    the windows and from device memory."""
    rots, transs = _check_inputs(ref_fea, src_feas, rots, transs, depth, y0)
    B, H, W, C = ref_fea.shape
    V, Hs, D = src_feas.shape[1], src_feas.shape[2], depth.shape[1]
    dev = ref_fea.device
    dc, cap = window_plan("fwd", C, ref_fea.dtype, D)
    out = torch.empty((B, V, D, H, W), dtype=ref_fea.dtype, device=dev)
    _kernels.launch(
        "warp_correlate", ref_fea, ref_fea.data_ptr(), src_feas.data_ptr(),
        rots.data_ptr(), transs.data_ptr(), depth.data_ptr(), out.data_ptr(),
        B, V, D, H, Hs, W, C, y0, ref_fea.stride(0), src_feas.stride(0),
        *depth.stride(), dc, cap, _stats_ptr(stats, 2, dev))
    return out


def _views_bwd_cuda(ref_fea, src_feas, rots, transs, depth, g, stats=None,
                    y0=0):
    """K3: (d_ref (B,H,W,C), d_src (B,V,Hs,W,C)) in the features' dtype
    for the cotangent g (B,V,D,H,W) of ``_views_cuda``'s output (ref rows
    from y0).  ``stats``, an int64 tensor of 3 on the card, gains the adds
    into the windows, into d_src directly and of the windows' flush."""
    rots, transs = _check_inputs(ref_fea, src_feas, rots, transs, depth, y0)
    B, H, W, C = ref_fea.shape
    V, Hs, D = src_feas.shape[1], src_feas.shape[2], depth.shape[1]
    dev = ref_fea.device
    if tuple(g.shape) != (B, V, D, H, W) or g.device != dev:
        raise ValueError(f"cotangent {tuple(g.shape)} on {g.device} does not "
                         f"match the output ({B},{V},{D},{H},{W}) on {dev}")
    dc, cap = window_plan("bwd", C, ref_fea.dtype, D)
    g = g.to(ref_fea.dtype).contiguous()
    d_ref = torch.empty((B, H, W, C), dtype=ref_fea.dtype, device=dev)
    part = torch.empty((B, V, H, W, C), dtype=torch.float32, device=dev)
    d_src = torch.zeros((B, V, Hs, W, C), dtype=torch.float32, device=dev)
    _kernels.launch(
        "warp_correlate_bwd", ref_fea, ref_fea.data_ptr(),
        src_feas.data_ptr(), rots.data_ptr(), transs.data_ptr(),
        depth.data_ptr(), g.data_ptr(), d_ref.data_ptr(), part.data_ptr(),
        d_src.data_ptr(), B, V, D, H, Hs, W, C, y0, ref_fea.stride(0),
        src_feas.stride(0), *depth.stride(), dc, cap,
        _stats_ptr(stats, 3, dev))
    return d_ref, d_src.to(src_feas.dtype)


class _WarpCorrelate(torch.autograd.Function):
    """K1 forward, K3 backward.  The saved depth is the caller's tensor as
    it is: the stage-1 sweep stays an expanded view."""

    @staticmethod
    def forward(ctx, ref_fea, src_feas, rots, transs, depth, y0):
        ctx.save_for_backward(ref_fea, src_feas, rots, transs, depth)
        ctx.y0 = y0
        return _views_cuda(ref_fea, src_feas, rots, transs, depth, y0=y0)

    @staticmethod
    def backward(ctx, g):
        d_ref, d_src = _views_bwd_cuda(*ctx.saved_tensors, g, y0=ctx.y0)
        return d_ref, d_src, None, None, None, None


def warp_correlate_views(ref_fea, src_feas, rots, transs, depth, y0=0):
    """Correlation of the ref features with every source view warped to
    each depth hypothesis (G=1).

    ref_fea (B,H,W,C), src_feas (B,V,Hs,W,C), rots (B,V,3,3), transs
    (B,V,3), depth (B,D,H,W) actual depths -> (B,V,D,H,W) in the
    features' dtype.  ``ref_fea`` and ``depth`` hold rows y0 .. y0 + H - 1
    of the reference (a row block under spatial sharding), whose rays
    project into the whole source maps; all rows: y0 = 0, H = Hs.
    ``depth`` may be an expanded view (the stage-1 sweep); the kernel
    reads it through its strides.
    """
    if ref_fea.device.type == "cuda":
        return _WarpCorrelate.apply(ref_fea, src_feas, rots, transs, depth,
                                    y0)
    if ref_fea.device.type != "cpu":
        raise ValueError(f"unsupported device {ref_fea.device}")
    return _views_torch(ref_fea, src_feas, rots, transs, depth,
                        y0).to(ref_fea.dtype)
