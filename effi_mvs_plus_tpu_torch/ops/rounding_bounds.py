"""The range of outputs K2's and K4's bf16 arithmetic can give, for the
checks (``chip_smoke.py``, the card tests); nothing on the model's path
uses it.

K2 and K4 round intermediates to bf16 where the TPU kernels do (K2: r*h
before the q convolution, ``pallas_gru.py:149``; K4: each layer's output,
``pallas_conv.py``), each after an fp32 sum in its own order.  Where an
intermediate's exact value lies within that sum's fp32 noise of a bf16
rounding boundary, two correct implementations (the kernel and the plain
version) may round it to either neighbour, and every output it reaches
moves by that ulp times a weight, which an elementwise tolerance cannot
absorb.  So these functions compute in float64 and carry the interval of
each rounded value, [round(v - tau), round(v + tau)], where tau bounds the
fp32 noise of v, through the next convolution (its positive and negative
weights apart) and the monotone epilogue, to an interval [lo, hi] of each
output.  Where no intermediate an output reads lies within tau of a
boundary, lo = hi = the exact value.  A check asks the kernel's output to
lie within its usual tolerance of [lo, hi].

tau is NOISE units of fp32 roundoff (2^-24) of the sum of the magnitudes
of the summed terms, the scale of an fp32 sum's rounding error, carried
through the sigmoid and the product with h for K2, plus 4 units of the
value (the fp32 sigmoid and product).
"""

from __future__ import annotations

import torch

from effi_mvs_plus_tpu_torch import nn

NOISE = 32
_U = 2.0 ** -24


def _conv(x, w, b=None):
    return nn.conv2d(x, w, b, padding=1)


def _spread(d_lo, d_hi, w):
    """The least and the most a 3x3 convolution with w adds to its output
    when each input moves anywhere in [d_lo, d_hi] (d_lo <= 0 <= d_hi)."""
    wp, wn = w.clamp(min=0), w.clamp(max=0)
    d = torch.cat([d_lo, d_hi], -1)
    return _conv(d, torch.cat([wp, wn], 1)), _conv(d, torch.cat([wn, wp], 1))


def _rounded(v, dt):
    return v.to(dt).double()


def gru_bounds(h, x, wz, wr, wq, bz, br, bq):
    """[lo, hi] of K2's h' before its last rounding (``cuda_gru.
    _gru_reference`` with ``rounded=False``) over the two roundings of
    every r*h within fp32 noise of a bf16 boundary; float64.  Also returns
    how many r*h values have two roundings."""
    dt, hd = h.dtype, h.shape[-1]
    hf, xf = h.double(), x.double()
    hx = torch.cat([hf, xf], -1)
    wzr = torch.cat([wz, wr]).to(dt).double()
    zr = torch.sigmoid(_conv(hx, wzr, torch.cat([bz, br]).double()))
    z, r = zr[..., :hd], zr[..., hd:]
    scale = _conv(hx.abs(), wzr[hd:].abs(), br.double().abs())
    rh = r * hf
    tau = NOISE * _U * r * (1 - r) * hf.abs() * scale + 4 * _U * rh.abs()
    near = _rounded(rh, dt)
    lo, hi = _rounded(rh - tau, dt) - near, _rounded(rh + tau, dt) - near
    wq = wq.to(dt).double()
    q = _conv(torch.cat([near, xf], -1), wq, bq.double())
    q_lo, q_hi = _spread(lo, hi, wq[:, :hd])
    return (hf + z * (torch.tanh(q + q_lo) - hf),
            hf + z * (torch.tanh(q + q_hi) - hf), int((lo != hi).sum()))


def chain_bounds(x, specs):
    """[lo, hi] of K4's output (``cuda_conv._chain_torch``: every layer's
    output rounded to x's dtype) over the two roundings of every value
    within fp32 noise of a boundary, layer after layer; float64.  Also
    returns how many values, summed over the layers, have two roundings
    (their own, or one of a value they read)."""
    dt = x.dtype
    y, lo, hi, two = x.double(), None, None, 0
    for w, b in specs:
        w, b = w.to(dt).double(), b.double()
        a = _conv(y, w, b)
        tau = NOISE * _U * _conv(y.abs(), w.abs(), b.abs())
        a_lo, a_hi = (a, a) if lo is None else (a + s for s in
                                                _spread(lo, hi, w))
        y = _rounded(torch.relu(a), dt)
        lo = _rounded(torch.relu(a_lo - tau), dt) - y
        hi = _rounded(torch.relu(a_hi + tau), dt) - y
        two += int((lo != hi).sum())
    return y + lo, y + hi, two
