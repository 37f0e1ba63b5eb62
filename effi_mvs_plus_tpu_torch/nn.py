"""Layer semantics of ``effi_mvs_plus_tpu/nn.py`` in PyTorch, eval and
train mode.

Tensors are channels-last, as in the JAX package: (B,H,W,C) and
(B,D,H,W,C).  Each function hands PyTorch a channels-first *view* of the
same memory (``permute``), which is the ``channels_last`` memory format,
so cuDNN runs in that format and no copy is made either way.  Weights keep
PyTorch's own layouts — (O,I,kh,kw), (O,I,kd,kh,kw) and, for the
transpose convolution, (I,O,kd,kh,kw) — which are the layouts of the
shipped state dict.

* ``conv2d/conv3d``  — symmetric zero padding, floor striding.  As in the
  JAX package the bias is added after the convolution, in the output's
  dtype: in bf16 that is a second rounding, which the reference has too.
  On the card a 3-D weight that trains takes its gradient from
  ``ops/conv_wgrad.py``, a split-K GEMM in place of cuDNN's.
* ``conv_transpose3d`` — torch ``ConvTranspose3d(stride, padding,
  output_padding)``: output size per dim
  ``(in-1)*stride - 2*pad + k + output_padding``.
* ``batch_norm`` — eps 1e-5.  Eval: running statistics.  Train (the
  module's ``training`` flag): fp32 batch statistics ``E[x²] − E[x]²``,
  normalisation with the biased variance, running statistics updated in
  place with the unbiased variance and momentum 0.1.  With ``groups=G``
  the leading axis is (B, G) flattened and each group has its own
  statistics, the per-view BN of the reference, which runs its views
  through the network one at a time.  Under a data-parallel policy
  (``parallel/mesh.py``) the sums and sums of squares are all-reduced
  over the data group first, so the statistics are the global batch's;
  inside ``parallel.view_stats`` the running update gathers every view's
  statistics from the model group; inside ``parallel.depth_blocks``
  under a depth policy, and inside ``parallel.row_blocks`` under a
  spatial one, they are all-reduced over the model group too, whose
  ranks hold the other D-blocks of the volume or row blocks of the
  tensor.
* 3-D ``Conv`` inside ``parallel.depth_blocks`` under a depth policy —
  the input is this rank's D-block of a volume; the convolution runs on
  it with the halo planes of the neighbouring ranks in place of its
  D-padding (``parallel.run_blocked``, ``valid``).  Every ``Conv`` inside
  ``parallel.row_blocks`` under a spatial policy does the same along H
  with the halo rows of the ranks above and below.
* ``softmax`` — op by op as XLA computes ``jax.nn.softmax``, each step
  rounded to the input's dtype, where ``torch.softmax`` rounds once at
  the end.  ``sigmoid`` — the same in bf16; ``torch.sigmoid`` in fp32,
  for its finite gradient.
* ``ChannelDropout`` — Dropout2d: one keep/drop per (sample, channel),
  scaled by 1/(1-p), in train mode only; its random draws come from the
  module's ``generator`` (``use_generator`` sets it model-wide); a data
  rank draws the global batch's mask and keeps its own rows, and every
  model rank draws the same mask (the same generator state, and a mask
  shape that the rows a rank holds do not change).

The modules below hold parameters under the reference state-dict names
(``conv.weight``, ``bn.running_mean`` ...) with torch's default
initialisation, and call these functions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from effi_mvs_plus_tpu_torch.ops import conv_wgrad
from effi_mvs_plus_tpu_torch.parallel import mesh as par

MOMENTUM = 0.1


def _cf(x):
    """channels-last (B,...,C) -> channels-first view (B,C,...)."""
    return x.movedim(-1, 1)


def _cl(y):
    """channels-first (B,C,...) -> channels-last view (B,...,C)."""
    return y.movedim(1, -1)


def _add_bias(y, b):
    return y if b is None else y + b.to(y.dtype)


def conv2d(x, w, b=None, stride=1, padding=0):
    """x: (B,H,W,I); w: (O,I,kh,kw).  Torch Conv2d semantics."""
    return _add_bias(_cl(F.conv2d(_cf(x), w.to(x.dtype), None, stride,
                                  padding)), b)


def conv3d(x, w, b=None, stride=1, padding=0):
    """x: (B,D,H,W,I); w: (O,I,kd,kh,kw).  Torch Conv3d semantics."""
    w = w.to(x.dtype)
    conv = conv_wgrad.conv3d if conv_wgrad.applies(x, w) else F.conv3d
    return _add_bias(_cl(conv(_cf(x), w, None, stride, padding)), b)


def conv_transpose3d(x, w, b=None, stride=1, padding=0, output_padding=0):
    """x: (B,D,H,W,I); w: (I,O,kd,kh,kw).  Torch ConvTranspose3d
    semantics."""
    w = w.to(x.dtype)
    conv = conv_wgrad.conv_transpose3d if conv_wgrad.applies(x, w) \
        else F.conv_transpose3d
    return _add_bias(_cl(conv(_cf(x), w, None, stride, padding,
                              output_padding)), b)


def softmax(x, dim):
    """``jax.nn.softmax``: exp(x - max) over the fp32 sum (rounded)."""
    u = torch.exp(x - x.amax(dim, keepdim=True))
    return u / u.float().sum(dim, keepdim=True).to(x.dtype)


def sigmoid(x):
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)) in bf16.  fp32 keeps
    ``torch.sigmoid``, whose backward σ(1-σ) is finite everywhere: autograd
    of the op-by-op form gives 0 * inf = NaN below x = -88, where exp(-x)
    overflows, and fp32 is the dtype that trains."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _update_running(bn, mean, unbiased):
    """The reference updates the running statistics once per view, in
    order: r' = (1-m)^g r + sum_v m (1-m)^(g-1-v) stat_v over the g
    groups (under view sharding, every rank's views)."""
    m = MOMENTUM
    with torch.no_grad():
        mean, unbiased = par.gather_view_stats(mean, unbiased)
        g = mean.shape[0]
        w = m * (1 - m) ** torch.arange(g - 1, -1, -1, dtype=mean.dtype,
                                        device=mean.device)
        bn.running_mean.copy_((1 - m) ** g * bn.running_mean + w @ mean)
        bn.running_var.copy_((1 - m) ** g * bn.running_var + w @ unbiased)
        bn.num_batches_tracked.add_(g)


def batch_norm(x, bn, groups=1):
    """BatchNorm over the last (channel) axis with the parameters and
    running statistics of ``bn`` (a ``BatchNorm`` holder), eps 1e-5;
    batch statistics when ``bn.training``, per group of the leading axis
    taken as (B, groups) flattened row-major."""
    if not bn.training:
        inv = torch.rsqrt(bn.running_var.float() + bn.eps)
        scale = (bn.weight * inv).to(x.dtype)
        shift = (bn.bias - bn.running_mean * bn.weight * inv).to(x.dtype)
        return x * scale + shift
    g = int(groups)
    xg = x.reshape(x.shape[0] // g, g, *x.shape[1:])
    xf = xg.to(torch.promote_types(xg.dtype, torch.float32))  # >= fp32
    axes = (0,) + tuple(range(2, xg.dim() - 1))
    # sums over this rank's rows, then over the data group's, then, on a
    # D-block or a row block, over the model group's (identities without a
    # policy): the global batch's whole volume
    n = par.block_count(xg.numel() // (g * xg.shape[-1])
                        * par.data_parallel(), x.shape[-3])
    sums = par.reduce_blocks(par.reduce_data(
        torch.stack([xf.sum(axes), (xf * xf).sum(axes)])))
    mean = sums[0] / n                                     # (g, C)
    var = sums[1] / n - mean * mean
    _update_running(bn, mean.detach(), var.detach() * (n / max(n - 1, 1)))
    inv = torch.rsqrt(var + bn.eps)
    bshape = (1, g) + (1,) * (xg.dim() - 3) + (-1,)
    scale = (bn.weight * inv).reshape(bshape).to(x.dtype)
    shift = (bn.bias - mean * bn.weight * inv).reshape(bshape).to(x.dtype)
    return (xg * scale + shift).reshape(x.shape)


class Conv(nn.Module):
    """Parameter holder of one convolution (``weight`` [, ``bias``]),
    initialised as torch's ``ConvNd`` / ``ConvTransposeNd``."""

    def __init__(self, nd, cin, cout, k, stride=1, padding=0, bias=True,
                 transpose=False, output_padding=0):
        super().__init__()
        ks = (k,) * nd if isinstance(k, int) else tuple(k)
        shape = (cin, cout) + ks if transpose else (cout, cin) + ks
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.nd, self.stride, self.padding = nd, stride, padding
        self.transpose, self.output_padding = transpose, output_padding
        # what an output reads, for a block of the input (parallel.on_block)
        self.reach = {"taps": ks, "stride": stride, "transpose": transpose,
                      "valid": True}
        self.reset_parameters()

    def reset_parameters(self):
        # torch's default: kaiming_uniform(a=sqrt(5)) over the stored
        # layout's fan-in (I*k for a conv, O*k for a transpose conv)
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            bound = 1 / math.sqrt(self.weight[0].numel())
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return par.run_blocked(self._conv, x, **self.reach)

    def _conv(self, x, unpadded=None):
        """The convolution; with no padding along axis ``unpadded`` of x
        (a block with its halo, ``parallel.on_block``), where a padding of
        (k - 1) / 2 (and a transpose's output padding of stride - 1) maps
        a block onto a block."""
        pad, opad = self.padding, self.output_padding
        if unpadded is not None:
            i, nd = unpadded - 1, self.nd
            k, s = self.weight.shape[2 + i], _per_dim(self.stride, nd)[i]
            pad, opad = _per_dim(pad, nd), _per_dim(opad, nd)
            if 2 * pad[i] != k - 1 or (self.transpose and opad[i] != s - 1):
                raise ValueError(
                    f"a {nd}-D {'transpose ' if self.transpose else ''}"
                    f"convolution (k {k}, stride {s}, padding {pad[i]}, "
                    f"output padding {opad[i]} along axis {unpadded}) does "
                    f"not map a block onto a block")
            pad = pad[:i] + (0,) + pad[i + 1:]
            opad = opad[:i] + (0,) + opad[i + 1:]
        if self.transpose:
            return conv_transpose3d(x, self.weight, self.bias, self.stride,
                                    pad, opad)
        fn = conv2d if self.nd == 2 else conv3d
        return fn(x, self.weight, self.bias, self.stride, pad)


def _per_dim(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


class BatchNorm(nn.Module):
    """Parameter holder with the state-dict names of torch BatchNorm."""

    eps = 1e-5

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, groups=1):
        return batch_norm(x, self, groups)


class ChannelDropout(nn.Module):
    """Dropout2d on channels-last tensors: in train mode each (sample,
    channel) is kept with probability 1-p, mask shape (B,1,...,1,C), and
    kept values are scaled by 1/(1-p); the identity in eval mode.  The
    masks are drawn from ``generator`` (torch's default one if None)."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p <= 0:
            return x
        rows, first = par.dropout_rows(x.shape[0])
        shape = (rows,) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        keep = torch.rand(shape, generator=self.generator, device=x.device
                          )[first:first + x.shape[0]] >= self.p
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device)
                           ).to(x.dtype)


class ConvBlock(nn.Module):
    """The reference ``Conv2d``/``Conv3d``/``Deconv3d`` wrappers:
    conv (no bias) + BN (+ ReLU), under the names ``conv`` and ``bn``."""

    def __init__(self, nd, cin, cout, k=3, stride=1, padding=1, relu=True,
                 transpose=False, output_padding=0):
        super().__init__()
        self.conv = Conv(nd, cin, cout, k, stride, padding, bias=False,
                         transpose=transpose, output_padding=output_padding)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x, groups=1):
        y = self.bn(self.conv(x), groups)
        return torch.relu(y) if self.relu else y


def use_generator(model, generator):
    """Draw every ``ChannelDropout`` mask of ``model`` from ``generator``
    (a ``torch.Generator`` on the model's device)."""
    for m in model.modules():
        if isinstance(m, ChannelDropout):
            m.generator = generator
