"""Fused chain of 3x3 conv (+ folded eval BN) + ReLU layers (kernel K4).

Port of ``effi_mvs_plus_tpu/ops/pallas_conv.py``.  ``conv_bn_relu_chain``
dispatches by the tensor's device: a CUDA tensor launches the
hand-written kernel of ``csrc/conv_chain.cu``, a CPU tensor takes the
plain version ``_chain_torch``.  Inference only, as on the TPU: the BN is
folded in running-statistic form and there is no backward, so an input
that requires grad is refused.

The kernel runs bf16 layers of 8 or more channels on the tensor cores and
everything else on the CUDA cores (``csrc/conv3x3_tile.cuh``); both keep
``_chain_torch``'s rounding.

The TPU kernel's fit predicate (``chain_fits``), its padding of the input
channels to 8 and its 128-lane padded width are TPU layout and are not
ported: the CUDA kernel takes every chain of the FPN as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from effi_mvs_plus_tpu_torch.ops import _kernels, conv_pack
from effi_mvs_plus_tpu_torch.utils import profiling

# channel chains the kernel is built for (csrc/conv_chain.cu EFFI_CHAINS):
# the six stride-1 runs of the two FPNs, then a one- and a three-layer
# chain that only the GPU tests launch, to hold the kernel's layer count
# (1 to 3) against the plain version
CHAINS = ((3, 4, 4), (3, 8, 8), (8, 8, 8), (16, 16, 16), (32, 32, 32),
          (64, 64, 64), (8, 16), (3, 8, 8, 16))


def fold_bn(w, bn, eps=1e-5, conv_bias=None):
    """Fold eval-mode BN into a convolution, in fp32: returns (w', b').
    w (O, I, kh, kw); ``bn`` holds ``weight``, ``bias``, ``running_mean``
    and ``running_var`` (O,)."""
    g = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
    w = w.float() * g[:, None, None, None]
    b = bn.bias.float() - bn.running_mean.float() * g
    if conv_bias is not None:
        b = b + conv_bias.float() * g
    return w, b


def _chain_torch(x, specs):
    """Plain PyTorch version.  x (B,H,W,C0); specs [(w (Co,Ci,3,3),
    b (Co,))].  Each layer in fp32 on the input's values with its weights
    rounded to the input's dtype, and each output rounded to that dtype,
    as the TPU kernel stores its intermediates."""
    dt = x.dtype
    y = x
    for w, b in specs:
        z = F.conv2d(y.float().movedim(-1, 1), w.to(dt).float(), b.float(),
                     padding=1)
        y = torch.relu(z).movedim(1, -1).to(dt)
    return y


def pack_weights(specs, dtype):
    """The kernel's weights for inputs of ``dtype``, layer by layer, each
    in its route's layout (``conv_pack``), as bytes."""
    return torch.cat([conv_pack.pack(w, dtype) for w, _ in specs])


def pack(specs, dtype):
    """The kernel's operands for ``specs`` (as ``conv_bn_relu_chain``'s)
    and inputs of ``dtype``: ``conv_pack.Packed``."""
    return conv_pack.Packed(dtype, pack_weights(specs, dtype), torch.cat(
        [b.detach().float() for _, b in specs]).contiguous())


def _chain_cuda(x, specs, packed):
    B, H, W, _ = x.shape
    chans = (x.shape[-1],) + tuple(w.shape[0] for w, _ in specs)
    _kernels.check_dtype(x=x)
    if chans not in CHAINS:
        raise ValueError(f"channel chain {chans} is not one the kernel is "
                         f"built for: {CHAINS}")
    out = torch.empty((B, H, W, chans[-1]), dtype=x.dtype, device=x.device)
    _kernels.check_dense(x=x, out=out)
    if packed is None:
        packed = pack(specs, x.dtype)
        profiling.count("conv_pack.packs")
    packed.check(x.dtype, x.device)
    c = list(chans) + [0] * (4 - len(chans))
    _kernels.launch("conv_chain", x, x.data_ptr(), packed.weights.data_ptr(),
                    packed.bias.data_ptr(), out.data_ptr(), B, H, W, *c)
    return out


def conv_bn_relu_chain(x, specs, packed=None):
    """Fused chain of 3x3 stride-1 pad-1 conv (+ folded scale and bias) +
    ReLU layers.  x (B,H,W,C0) channels-last; specs [(w (Co,Ci,3,3),
    b (Co,)), ...] with BN already folded (``fold_bn``).  ``packed``:
    ``pack(specs, x.dtype)``, made once by a caller whose weights no longer
    change; otherwise the kernel's call packs.  Returns (B,H,W,C_L) in x's
    dtype."""
    tensors = [x] + [t for spec in specs for t in spec]
    if any(t.requires_grad for t in tensors):
        raise ValueError("conv_bn_relu_chain is inference only (no "
                         "backward): call it under torch.no_grad() or "
                         "torch.inference_mode()")
    if x.dim() != 4:
        raise ValueError(f"x must be (B,H,W,C), got {tuple(x.shape)}")
    ci = x.shape[-1]
    for w, b in specs:
        if w.dim() != 4 or tuple(w.shape[1:]) != (ci, 3, 3) \
                or tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"layer ({tuple(w.shape)}, {tuple(b.shape)}) "
                             f"does not take {ci} channels with 3x3 taps")
        ci = w.shape[0]
    for t in tensors[1:]:
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")
    if x.device.type == "cuda":
        return _chain_cuda(x, specs, packed)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return _chain_torch(x, specs)
