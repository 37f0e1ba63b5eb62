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
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.ops import _kernels

# Launches of the CUDA kernel in this process (the wrapper adds one per
# launch; nothing else touches it but a caller that resets it to 0).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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


def _pack(w, dtype):
    """(O, I, 3, 3) -> fp32 [9][I][O], rounded to the inputs' dtype first."""
    return w.to(dtype).float().permute(2, 3, 1, 0).reshape(
        9, w.shape[1], w.shape[0]).contiguous()


def _gru_cuda(h, x, wz, wr, wq, bz, br, bq):
    global launches
    B, H, W, hd = h.shape
    dev = h.device
    if h.dtype not in _DTYPES or x.dtype != h.dtype:
        raise ValueError(f"h and x must share one of {list(_DTYPES)}, got "
                         f"{h.dtype} / {x.dtype}")
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
    if not (h.is_contiguous() and x.is_contiguous()):
        raise ValueError("h and x must be contiguous (B,H,W,hd)")
    w1 = _pack(torch.cat([wz, wr], 0), h.dtype)           # [9][2hd][2hd]
    b1 = torch.cat([bz, br]).float().contiguous()
    w2 = _pack(wq, h.dtype)                               # [9][2hd][hd]
    b2 = bq.float().contiguous()
    out = torch.empty_like(h)
    lib = _kernels.library()
    with torch.cuda.device(dev):
        status = lib.effi_conv_gru(
            h.data_ptr(), x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), B, H, W, hd,
            _DTYPES[h.dtype], _kernels.stream_of(out))
    _kernels.check(status, "conv_gru")
    launches += 1
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


def gru_step(h, x, p):
    """ConvGRU step.  h (B,H,W,hd), x (B,H,W,xd); ``p`` holds ``convz``,
    ``convr`` and ``convq``, each with ``weight`` (hd, hd+xd, 3, 3) and
    ``bias`` (hd,).  Returns h' (B,H,W,hd) in h's dtype."""
    args = (h, x, p.convz.weight, p.convr.weight, p.convq.weight,
            p.convz.bias, p.convr.bias, p.convq.bias)
    if h.device.type == "cuda":
        return _ConvGRU.apply(*args)
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    return _gru_torch(*args)
