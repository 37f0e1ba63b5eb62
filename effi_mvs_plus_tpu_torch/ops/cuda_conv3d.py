"""One 3-D layer of the serving forward's cost regularisation, fused:
3x3x3 convolution or transposed convolution + running-statistic BN +
ReLU + residual, with the cross-scale block's concatenated input.

``conv3d_reg`` dispatches by the tensor's device: a CUDA tensor launches
the hand-written kernel of ``csrc/conv3d_reg.cu`` (no fallback: a layer
the kernel is not built for raises), a CPU tensor takes the plain
version ``_reg_torch``.  Inference only: BN is in its running-statistic
form and there is no backward, so an input that requires grad is
refused.  ``CostRegNet`` and ``CSPBlock`` (``models/blocks.py``) take
this path where ``blocks.reg_applies``; it replaces no TPU kernel, since
the JAX package runs these layers through XLA.

Arithmetic (both versions): the convolution in fp32 over the input's
values and the weights rounded to the input's dtype, then
``y * scale + shift`` in fp32 with BN's scale and shift in fp32, ReLU
where the block has it, the residual added in fp32, and one rounding to
the input's dtype at the end, as ``cuda_conv._chain_torch`` rounds.

The kernel runs bf16 layers of 8 or more input and output channels on
the tensor cores and the rest on the CUDA cores (the rule of
``conv_pack.mma_route``, as for K2 and K4).  It reads the module's own
fp32 weights and BN tensors and lays them out in shared memory itself,
so nothing is packed or kept on the device beside the model.  Each
launch adds one to the counter ``conv3d_reg.launches``
(``utils/profiling.py``): 25 a served forward of ``EffiMVS``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.ops import _kernels

# (stride, transposed) -> the kernel's mode (csrc/conv3d_reg.cu); the
# layers it is built for are listed there alone (EFFI_REG_LAYERS), and it
# returns cudaErrorInvalidValue for any other
MODES = {((1, 1, 1), False): 0, ((2, 2, 2), False): 1, ((1, 2, 2), False): 2,
         ((2, 2, 2), True): 3, ((1, 2, 2), True): 4}


class Layer(NamedTuple):
    """One layer's operands, the module's own tensors (detached):
    ``weight`` fp32 ((O, I, 3, 3, 3), a transposed one (I, O, 3, 3, 3))
    and ``bn``, the ``nn.BatchNorm`` whose running statistics follow it
    (None for a plain convolution)."""
    weight: torch.Tensor
    bn: Optional[nn.BatchNorm]
    relu: bool
    stride: tuple
    transpose: bool

    @property
    def channels(self):
        """(input channels, output channels)."""
        a, b = self.weight.shape[:2]
        return (a, b) if self.transpose else (b, a)

    def affine(self):
        """BN's running-statistic (scale, shift), fp32 (O,): g / sqrt(var +
        eps) and b - mean * scale; ones and zeros without BN."""
        co = self.channels[1]
        if self.bn is None:
            return (torch.ones(co, device=self.weight.device),
                    torch.zeros(co, device=self.weight.device))
        bn = self.bn
        scale = bn.weight.detach().float() * torch.rsqrt(
            bn.running_var.float() + bn.eps)
        return scale, bn.bias.detach().float() - bn.running_mean.float() * scale


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def layer(block):
    """The ``Layer`` of an ``nn.ConvBlock`` (conv + BN (+ ReLU)) or of a
    plain 3x3x3 ``nn.Conv``.  The convolution must have 3x3x3 taps,
    padding 1, no bias and, if transposed, output padding stride - 1."""
    conv = block.conv if isinstance(block, nn.ConvBlock) else block
    w = conv.weight.detach()
    stride = _triple(conv.stride)
    if (conv.nd != 3 or tuple(w.shape[2:]) != (3, 3, 3)
            or _triple(conv.padding) != (1, 1, 1) or conv.bias is not None
            or (conv.transpose and _triple(conv.output_padding)
                != tuple(s - 1 for s in stride))):
        raise ValueError("conv3d_reg takes 3x3x3 layers of padding 1 and no "
                         "bias (a transposed one with output padding "
                         "stride - 1)")
    if isinstance(block, nn.ConvBlock):
        return Layer(w, block.bn, block.relu, stride, conv.transpose)
    return Layer(w, None, False, stride, conv.transpose)


def out_shape(x, layer_):
    """(B, Do, Ho, Wo, O) of ``layer_`` on x (B, D, H, W, C)."""
    dims = []
    for n, s in zip(x.shape[1:4], layer_.stride):
        dims.append(n * s if layer_.transpose else (n - 1) // s + 1)
    return (x.shape[0], *dims, layer_.channels[1])


def _reg_torch(x, layer_, x2=None, res=None):
    """Plain PyTorch version (module docstring's arithmetic)."""
    dt = x.dtype
    scale, shift = layer_.affine()
    xin = x if x2 is None else torch.cat([x, x2], -1)
    xf = xin.float().movedim(-1, 1)
    w = layer_.weight.to(dt).float()
    if layer_.transpose:
        y = F.conv_transpose3d(xf, w, None, layer_.stride, 1,
                               tuple(s - 1 for s in layer_.stride))
    else:
        y = F.conv3d(xf, w, None, layer_.stride, 1)
    y = y.movedim(1, -1) * scale + shift
    if layer_.relu:
        y = torch.relu(y)
    if res is not None:
        y = y + res.float()
    return y.to(dt)


def _reg_cuda(x, layer_, x2, res):
    _kernels.check_dtype(x=x)
    co = layer_.channels[1]
    cia, cib = x.shape[-1], 0 if x2 is None else x2.shape[-1]
    mode = MODES.get((layer_.stride, layer_.transpose), -1)
    bn = layer_.bn
    fp32 = [layer_.weight] + ([] if bn is None else [
        bn.weight, bn.bias, bn.running_mean, bn.running_var])
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in fp32):
        raise ValueError("the weights and BN's tensors must be contiguous "
                         "fp32")
    out = torch.empty(out_shape(x, layer_), dtype=x.dtype, device=x.device)
    _kernels.check_dense(x=x, x2=x2, res=res, out=out)
    g, b, mean, var = (0, 0, 0, 0) if bn is None else (
        bn.weight.data_ptr(), bn.bias.data_ptr(), bn.running_mean.data_ptr(),
        bn.running_var.data_ptr())
    B, Di, Hi, Wi = x.shape[:4]
    _, Do, Ho, Wo, _ = out.shape
    _kernels.launch(
        "conv3d_reg", x, x.data_ptr(), 0 if x2 is None else x2.data_ptr(),
        0 if res is None else res.data_ptr(), layer_.weight.data_ptr(),
        g, b, mean, var, 0.0 if bn is None else bn.eps, out.data_ptr(),
        B, Di, Hi, Wi, Do, Ho, Wo, cia, cib, co, mode, int(layer_.relu),
        int(res is not None))
    return out


def conv3d_reg(x, layer_, x2=None, res=None):
    """``layer_`` (a ``Layer``) on x (B, D, H, W, C) channels-last, with
    x2 (B, D, H, W, C2) appended to x's channels where given and ``res``
    (the output's shape) added after the ReLU.  Returns (B, Do, Ho, Wo, O)
    in x's dtype."""
    tensors = [t for t in (x, x2, res, layer_.weight) if t is not None]
    if any(t.requires_grad for t in tensors):
        raise ValueError("conv3d_reg is inference only (no backward): call "
                         "it under torch.no_grad() or torch.inference_mode()")
    if x.dim() != 5:
        raise ValueError(f"x must be (B,D,H,W,C), got {tuple(x.shape)}")
    ci = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
    if x2 is not None and (x2.shape[:-1] != x.shape[:-1]
                           or x2.dtype != x.dtype):
        raise ValueError(f"x2 {tuple(x2.shape)} {x2.dtype} does not extend "
                         f"x {tuple(x.shape)} {x.dtype}")
    if ci != layer_.channels[0]:
        raise ValueError(f"the layer takes {layer_.channels[0]} channels, "
                         f"not {ci}")
    if res is not None and (tuple(res.shape) != out_shape(x, layer_)
                            or res.dtype != x.dtype):
        raise ValueError(f"res {tuple(res.shape)} {res.dtype} is not the "
                         f"output's {out_shape(x, layer_)} {x.dtype}")
    for t in tensors[1:] + ([] if layer_.bn is None else [
            layer_.bn.running_mean]):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device}, x on {x.device}")
    if x.device.type == "cuda":
        return _reg_cuda(x, layer_, x2, res)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return _reg_torch(x, layer_, x2, res)
