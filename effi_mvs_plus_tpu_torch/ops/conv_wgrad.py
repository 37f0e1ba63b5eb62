"""The 3-D convolutions whose weights train, on the card: cuDNN's forward
and input gradient, and the weight gradient as a split-K GEMM.

For the training step's 3-D convolutions and transposed convolutions
(the cost regularisation and the cross-scale blocks) cuDNN computes the
weight gradient with ``wgrad2d_grouped_direct_kernel``, which spreads
over the few output weights (8 x 27 to 32 x 864) and not over the 15 k
to 1 M positions it sums over: on an H100, 143 ms of a DTU training step
at B=4, 42% of its device time, at 0.03-0.4 TFLOP/s.  Here the weight
gradient is the GEMM it is,

    dW (O, C·k) = Gᵀ · X̂,

with G (P, O) the output gradient and X̂ (P, C·k) the patch matrix of the
zero-padded channels-last input over the output's P positions (k the
kernel's taps).  The positions are taken a chunk at a time (whole
images, or runs of the first spatial axis of one image, ``plan``), so
the patch matrix is a transient of at most ``CHUNK_BYTES``; each chunk's
GEMM is split over ``slices`` runs of its positions and batched
(``torch.baddbmm``), so that cuBLAS spreads every GEMM over the card,
and each slice's partial sums stay in their own (O, C·k) buffer across
the chunks.  The buffers are summed at the end in a fixed order: no
atomics, the same bits on every call.  A transposed convolution's weight
gradient is the same GEMM with the roles of its input and its output
gradient exchanged.  A 1x1x1 convolution's patch matrix is its input, a
view where the input is dense.  The arithmetic is fp32 whatever the
inputs' dtype, and TF32 follows torch's matmul switch, which
``device.resolve_device`` turns off.

``nn.conv3d`` and ``nn.conv_transpose3d`` take this path where
``applies``: a CUDA tensor whose weight requires grad while grad is on.
The forward is ``F.conv3d``'s or ``F.conv_transpose3d``'s call as it
was, and the input gradient is cuDNN's (``aten.convolution_backward``
for the input alone), so every forward and every served or frozen path
is what it was.  The CPU keeps plain autograd, the oracle of the tests.
The 2-D convolutions keep cuDNN's weight gradient on the card: there its
implicit GEMM (``wgrad_alg0_engine_NHWC``) takes 21 ms of the step on an
H100, and their patch matrices would be 24.5 GB a step (``PERF.md``).

Counters (``utils/profiling.py``): ``conv_wgrad.calls`` (weight gradients
computed here) and ``conv_wgrad.patch_bytes`` (bytes of patch matrices
written).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from effi_mvs_plus_tpu_torch.utils import profiling

CHUNK_BYTES = 128 << 20  # patch matrix a chunk at most (torch_probe_wgrad)
BLOCKS = 1056            # GEMM tiles a chunk aims at: 8 on each of 132 SMs
TILE = 64                # the edge of a GEMM tile, for counting them
MIN_SLICE = 256          # positions a slice sums at least


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def applies(x, w):
    """Whether a convolution takes this path: x on a CUDA device, w
    requiring grad, grad on."""
    return x.is_cuda and w.requires_grad and torch.is_grad_enabled()


def plan(B, out, C, O, ksize, stride, budget=CHUNK_BYTES):
    """(images a chunk, runs of the first output axis a chunk, slices) of
    a weight gradient over B images of ``out`` output positions: whole
    images while one image's patch matrix fits ``budget``, else runs of
    its first axis; slices enough for about ``BLOCKS`` tiles, each of
    ``MIN_SLICE`` positions or more."""
    ck = C * math.prod(ksize)
    per_position = 4 * (ck + O + C * math.prod(stride))
    positions = budget // per_position
    run = math.prod(out[1:])
    if out[0] * run <= positions:
        images, rows = min(B, positions // (out[0] * run)), out[0]
    else:
        images, rows = 1, max(positions // run, 1)
    tiles = math.ceil(O / TILE) * math.ceil(ck / TILE)
    slices = max(1, min(math.ceil(BLOCKS / tiles),
                        images * rows * run // MIN_SLICE))
    return images, rows, slices


def weight_grad(x, g, ksize, stride=1, padding=0, budget=CHUNK_BYTES):
    """The weight gradient (O, C, *ksize), fp32, of a convolution of x
    (B, *spatial, C) channels-last (torch ConvNd semantics, no dilation,
    one group) whose output gradient is g (B, *out, O) channels-last.
    ``budget`` bounds the patch matrix of a chunk."""
    n = x.dim() - 2
    B, *size, C = x.shape
    ksize = tuple(ksize)
    stride, padding = _tuple(stride, n), _tuple(padding, n)
    out, O = list(g.shape[1:-1]), g.shape[-1]
    if [B] + out != [g.shape[0]] + [(i + 2 * p - k) // s + 1 for i, k, s, p
                                    in zip(size, ksize, stride, padding)]:
        raise ValueError(f"output gradient {tuple(g.shape)} does not match "
                         f"a {ksize} stride {stride} padding {padding} "
                         f"convolution of {tuple(x.shape)}")
    ck = C * math.prod(ksize)
    images, rows, n_slices = plan(B, out, C, O, ksize, stride, budget)
    acc = torch.zeros(n_slices, O, ck, dtype=torch.float32, device=x.device)
    k0, s0, p0 = ksize[0], stride[0], padding[0]
    inner = [q for p in reversed(padding[1:]) for q in (p, p)]
    base = x.untyped_storage().data_ptr()
    written = 0
    for b0 in range(0, B, images):
        for r0 in range(0, out[0], rows):
            r1 = min(r0 + rows, out[0])
            lo, hi = r0 * s0 - p0, (r1 - 1) * s0 - p0 + k0
            xc = x[b0:b0 + images, max(lo, 0):min(hi, size[0])]
            pads = [0, 0, *inner, max(-lo, 0), max(hi - size[0], 0)]
            if any(pads):
                xc = F.pad(xc, pads)
            for axis, (k, s) in enumerate(zip(ksize, stride), 1):
                xc = xc.unfold(axis, k, s)
            patch = xc.reshape(-1, ck)
            if patch.untyped_storage().data_ptr() != base:
                written += patch.nbytes
            gc = g[b0:b0 + images, r0:r1].reshape(-1, O)
            if patch.dtype != torch.float32:
                patch, gc = patch.float(), gc.float()
            m = gc.shape[0] // n_slices * n_slices
            if m:
                acc.baddbmm_(gc[:m].view(n_slices, -1, O).transpose(1, 2),
                             patch[:m].view(n_slices, -1, ck))
            if m < gc.shape[0]:
                acc[0].addmm_(gc[m:].t(), patch[m:])
    profiling.count("conv_wgrad.calls")
    profiling.count("conv_wgrad.patch_bytes", written)
    return acc.sum(0).view(O, C, *ksize)


class _Conv(torch.autograd.Function):
    """``F.conv3d`` / ``F.conv_transpose3d`` forward, cuDNN's input
    gradient, ``weight_grad``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed, output_padding):
        n = x.dim() - 2
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = _tuple(stride, n), _tuple(padding, n)
        ctx.transposed = transposed
        ctx.output_padding = _tuple(output_padding, n)
        if transposed:
            return F.conv_transpose3d(x, w, None, stride, padding,
                                      output_padding)
        return F.conv3d(x, w, None, stride, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward(
                g, x, w, None, ctx.stride, ctx.padding, (1,) * len(ctx.stride),
                ctx.transposed, ctx.output_padding, 1,
                (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            xl, gl = x.movedim(1, -1), g.movedim(1, -1)
            if ctx.transposed:          # a convolution of g whose output is x
                xl, gl = gl, xl
            gw = weight_grad(xl, gl, w.shape[2:], ctx.stride,
                             ctx.padding).to(w.dtype)
        return gx, gw, None, None, None, None


def conv3d(x, w, bias=None, stride=1, padding=0):
    """``F.conv3d(x, w, None, stride, padding)`` (x channels-first, a view
    of channels-last memory as ``nn.conv3d`` hands it) whose weight
    gradient is ``weight_grad``'s."""
    if bias is not None:
        raise ValueError("the bias is added after the convolution")
    return _Conv.apply(x, w, stride, padding, False, 0)


def conv_transpose3d(x, w, bias=None, stride=1, padding=0,
                     output_padding=0):
    """``F.conv_transpose3d(x, w, None, stride, padding, output_padding)``
    whose weight gradient is ``weight_grad``'s."""
    if bias is not None:
        raise ValueError("the bias is added after the convolution")
    return _Conv.apply(x, w, stride, padding, True, output_padding)
