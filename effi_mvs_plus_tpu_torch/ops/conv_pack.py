"""Weight packing for the 3x3 convolutions of K2 and K4
(``csrc/conv3x3_tile.cuh``).

A layer (w of shape (Co, Ci, 3, 3)) is packed into units, taps or tap
pairs, in the order the kernel reads them; the kernel streams them through
shared memory a few units a stage (``units_per_stage`` in the header):

* tensor-core route (``mma_route``: bf16 with 8 or more input and output
  channels): B fragments of mma.sync m16n8k16 in register order.  A unit
  is a tap (Ci a multiple of 16: Ci / 16 k16 steps) or a tap pair (Ci = 8:
  one k16 step, taps 2p and 2p + 1, the tenth tap zero), laid out
  [k-step][n-tile][lane][b0, b1][2] bf16: lane l holds output channel
  8 n + l // 4 and the k16 rows 2 (l % 4) + e (b0) and 2 (l % 4) + 8 + e
  (b1).  k16 row j of a tap step is input channel 16 kk + j; of a pair
  step, channel j % 8 of tap 2p + j // 8.
* CUDA-core route: a unit is a tap, [Ci padded to 4][Co] fp32 (the
  weights rounded to the inputs' dtype first), zero past Ci.

``pack`` gathers through a cached index table, so packing is one gather
on the weights' device.  The wrappers pack on every call unless handed a
``Packed`` made once where the weights are frozen
(``models.freeze_kernel_weights``): packing costs a dozen small operations
a launch.  Each packing at call time adds one to the counter
``conv_pack.packs`` (``utils/profiling.py``), so a frozen model reads 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class Packed(NamedTuple):
    """A kernel's operands for inputs of ``dtype``: its weights in the
    stage layout (uint8) and its biases (fp32)."""
    dtype: torch.dtype
    weights: torch.Tensor
    bias: torch.Tensor

    def check(self, dtype, device):
        if self.dtype != dtype or self.weights.device != device:
            raise ValueError(f"weights packed for {self.dtype} on "
                             f"{self.weights.device}, inputs {dtype} on "
                             f"{device}")


def mma_route(dtype, ci, co):
    """True where the kernels run a layer on the tensor cores."""
    return dtype == torch.bfloat16 and ci >= 8 and co >= 8


def unit_taps(ci, mma):
    """[(tap of k16 rows 0-7, tap of rows 8-15)] per unit on the
    tensor-core route (tap 9: the zero padding); [tap] per unit on the
    CUDA-core route."""
    if not mma:
        return list(range(9))
    if ci == 8:
        return [(2 * p, 2 * p + 1) for p in range(5)]
    return [(t, t) for t in range(9)]


@functools.cache
def _index(ci, co, mma):
    """Flat indices into w.reshape(-1) (w (co, ci, 3, 3)) of every packed
    element, in packed order; ci * co * 9 (one past the end) where the
    packed value is zero."""
    zero = ci * co * 9
    if mma:
        if ci % 16 and ci != 8:
            raise ValueError(f"the tensor-core route takes 8 or 16k input "
                             f"channels, not {ci}")
        if co % 8:
            raise ValueError(f"the tensor-core route takes 8k output "
                             f"channels, not {co}")
        ksteps = 1 if ci == 8 else ci // 16
        kk, n, lane, r, e = np.meshgrid(np.arange(ksteps), np.arange(co // 8),
                                        np.arange(32), np.arange(2),
                                        np.arange(2), indexing="ij")
        o = n * 8 + lane // 4
        j = 2 * (lane % 4) + e + 8 * r            # k16 row
        stages = []
        for taps in unit_taps(ci, True):
            if ci == 8:
                tap, ch = np.where(j < 8, taps[0], taps[1]), j % 8
            else:
                tap, ch = np.full_like(j, taps[0]), kk * 16 + j
            idx = (o * ci + ch) * 9 + tap
            stages.append(np.where(tap < 9, idx, zero).reshape(-1))
        return np.concatenate(stages)
    ci4 = -(-ci // 4) * 4
    c, o = np.meshgrid(np.arange(ci4), np.arange(co), indexing="ij")
    return np.concatenate([np.where(c < ci, (o * ci + c) * 9 + t, zero)
                           .reshape(-1) for t in range(9)])


@functools.cache
def _index_on(ci, co, mma, device):
    return torch.from_numpy(_index(ci, co, mma)).to(device)


def pack(w, dtype):
    """One layer's weights (Co, Ci, 3, 3) in the kernels' stage layout for
    inputs of ``dtype``, as bytes (uint8, 1-D)."""
    co, ci = w.shape[:2]
    mma = mma_route(dtype, ci, co)
    vals = w.detach().reshape(-1).to(dtype)
    if not mma:
        vals = vals.float()
    vals = torch.cat([vals, vals.new_zeros(1)])
    return vals[_index_on(ci, co, mma, w.device)].view(torch.uint8)
