"""One ConvGRU step (kernel K2).

Port of ``effi_mvs_plus_tpu/ops/pallas_gru.py::gru_step``.  A CUDA tensor
goes through ``_ConvGRU``, an autograd Function whose forward launches the
hand-written fused kernel of ``csrc/conv_gru.cu`` and whose backward
recomputes the step through the plain math under autograd, as
``pallas_gru._gru_fused_bwd`` does: the JAX package has no backward kernel
for the GRU, so there is none here.  A CPU tensor takes the plain version
``_gru_torch``, the math of ``pallas_gru._gru_xla``:

    z, r = sigmoid(conv3x3([h, x]) + b);  q = tanh(conv3x3([r*h, x]) + b_q)
    h' = (1 - z) * h + z * q

As in the JAX package the convolution weights are cast to the inputs'
dtype (a bf16 step rounds them to bf16); accumulation is fp32.

The kernel has two routes, by the inputs' dtype: bf16 on the tensor cores,
fp32 on the CUDA cores (``csrc/conv3x3_tile.cuh``).  In bf16 it rounds
where the TPU kernel rounds (r*h stored in bf16 before the q convolution,
``pallas_gru.py:149``), which ``_gru_reference`` repeats in plain PyTorch
for the checks.
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.ops import _kernels, conv_pack
from effi_mvs_plus_tpu_torch.utils import profiling

_HIDDEN = (16, 32, 48)


def _gru_torch(h, x, wz, wr, wq, bz, br, bq):
    """Plain PyTorch version.  h (B,H,W,hd), x (B,H,W,xd); weights
    (hd, hd+xd, 3, 3), biases (hd,)."""
    hd = h.shape[-1]
    hx = torch.cat([h, x], dim=-1)
    zr = nn.sigmoid(nn.conv2d(hx, torch.cat([wz, wr], 0),
                              torch.cat([bz, br]), padding=1))
    z, r = zr[..., :hd], zr[..., hd:]
    q = torch.tanh(nn.conv2d(torch.cat([r * h, x], dim=-1), wq, bq,
                             padding=1))
    return (1 - z) * h + z * q


def _gru_reference(h, x, wz, wr, wq, bz, br, bq, rounded=True):
    """The TPU kernel's arithmetic (``pallas_gru.py::_kernel``) in plain
    PyTorch, for the checks: fp32 math on the inputs' values with the
    weights rounded to the inputs' dtype, r*h rounded to it before the q
    convolution, h' = h + z (q - h) rounded once (``rounded=False``: the
    fp32 value before that last rounding).  In fp32 it is ``_gru_torch``'s
    function."""
    dt = h.dtype
    hf, xf = h.float(), x.float()
    hd = h.shape[-1]
    zr = nn.sigmoid(nn.conv2d(torch.cat([hf, xf], -1),
                              torch.cat([wz, wr], 0).to(dt).float(),
                              torch.cat([bz, br]).float(), padding=1))
    z, r = zr[..., :hd], zr[..., hd:]
    rh = (r * hf).to(dt).float()
    q = torch.tanh(nn.conv2d(torch.cat([rh, xf], -1), wq.to(dt).float(),
                             bq.float(), padding=1))
    out = hf + z * (q - hf)
    return out.to(dt) if rounded else out


def pack_weights(wz, wr, wq, dtype):
    """The kernel's weights for inputs of ``dtype``, as bytes: r's 9 taps,
    z's, q's r*h half's and q's x half's, each tap in the route's layout
    (``conv_pack``)."""
    hd = wq.shape[0]
    return torch.cat([conv_pack.pack(w, dtype) for w in
                      (wr, wz, wq[:, :hd], wq[:, hd:])])


def pack(p, dtype):
    """The kernel's operands from the GRU ``p`` (as ``gru_step``'s) for
    inputs of ``dtype``: ``conv_pack.Packed``."""
    return _pack(p.convz.weight, p.convr.weight, p.convq.weight,
                 p.convz.bias, p.convr.bias, p.convq.bias, dtype)


def _pack(wz, wr, wq, bz, br, bq, dtype):
    return conv_pack.Packed(dtype, pack_weights(wz, wr, wq, dtype),
                            torch.cat([bz, br, bq]).detach().float()
                            .contiguous())


def _gru_cuda(h, x, wz, wr, wq, bz, br, bq, packed=None):
    B, H, W, hd = h.shape
    dev = h.device
    _kernels.check_dtype(h=h, x=x)
    if hd not in _HIDDEN:
        raise ValueError(f"hidden width must be one of {_HIDDEN}, got {hd}")
    if tuple(x.shape) != (B, H, W, hd):
        raise ValueError(f"x {tuple(x.shape)} must match h {tuple(h.shape)}")
    for name, w in (("wz", wz), ("wr", wr), ("wq", wq)):
        if tuple(w.shape) != (hd, 2 * hd, 3, 3):
            raise ValueError(f"{name} must be ({hd},{2 * hd},3,3), got "
                             f"{tuple(w.shape)}")
    for name, t in (("x", x), ("wz", wz), ("wr", wr), ("wq", wq),
                    ("bz", bz), ("br", br), ("bq", bq)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h on {dev}")
    out = torch.empty_like(h)
    _kernels.check_dense(h=h, x=x, out=out)
    if packed is None:
        packed = _pack(wz, wr, wq, bz, br, bq, h.dtype)
        profiling.count("conv_pack.packs")
    packed.check(h.dtype, dev)
    _kernels.launch("conv_gru", h, h.data_ptr(), x.data_ptr(),
                    packed.weights.data_ptr(), packed.bias.data_ptr(),
                    out.data_ptr(), B, H, W, hd)
    return out


class _ConvGRU(torch.autograd.Function):
    """K2 forward; the backward reruns the three convolutions of the
    plain version and differentiates them."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _gru_cuda(*args)

    @staticmethod
    def backward(ctx, g):
        args = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = _gru_torch(*args)
        return torch.autograd.grad(out, args, g)


def gru_step(h, x, p, packed=None):
    """ConvGRU step.  h (B,H,W,hd), x (B,H,W,xd); ``p`` holds ``convz``,
    ``convr`` and ``convq``, each with ``weight`` (hd, hd+xd, 3, 3) and
    ``bias`` (hd,).  ``packed``: ``pack(p, h.dtype)``, made once by a
    caller whose weights no longer change, for the kernel's forward without
    grad; otherwise the kernel's call packs.  Returns h' (B,H,W,hd) in h's
    dtype."""
    args = (h, x, p.convz.weight, p.convr.weight, p.convq.weight,
            p.convz.bias, p.convr.bias, p.convq.bias)
    if h.device.type == "cuda":
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return _ConvGRU.apply(*args)
        return _gru_cuda(*args, packed=packed)
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    return _gru_torch(*args)
