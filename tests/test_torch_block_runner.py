"""The port's one seam for its kernels, on the CPU.

* ``parallel.on_block``, the block runner: every op kind that runs on a
  rank's D-block or row block (``nn.Conv`` 2-D, 3-D and transposed, the
  fused 3-D layer's five modes with ``x2`` and ``res``, K4's chain and
  K2's step through their plain versions, ``convex_upsample``'s
  neighbourhood) on two and on three uneven blocks along D and along H,
  each block given its halo cut from the whole tensor (a planted
  exchange), joined and held to the op on the whole tensor.  The
  exchange itself, ``parallel.halo``, is held to the whole tensor in
  ranks by tests/test_torch_parallel_depth.py and
  tests/test_torch_parallel_spatial.py.
* ``parallel.run_blocked`` returns the op on the whole tensor untouched
  where no policy blocks it.
* Every kernel wrapper still refuses, before it reaches the launch path
  (``ops/_kernels.launch``), the dtypes, alignments, layouts and shapes
  its kernel does not take.
"""

import pytest
import torch

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.ops import (cuda_conv, cuda_conv3d, cuda_gru,
                                         cuda_warp, upsample)
from effi_mvs_plus_tpu_torch.parallel import mesh as par

B, C = 2, 3


def _seeded(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _module(make):
    torch.manual_seed(0)
    m = make().eval()
    if isinstance(m, nn.ConvBlock):
        with torch.no_grad():
            m.bn.running_mean.uniform_(-0.5, 0.5)
            m.bn.running_var.uniform_(0.5, 2.0)
            m.bn.weight.uniform_(0.5, 1.5)
            m.bn.bias.uniform_(-0.5, 0.5)
    return m


def _conv(make):
    """An ``nn.Conv``: its convolution and its reach, as its forward."""
    conv = _module(make)
    return conv._conv, conv.reach, None


def _reg(ci, co, stride=1, transpose=False, relu=True, extra=None):
    """One fused 3-D layer (``blocks._reg_layer``'s op and reach) on
    inputs of ci channels (two halves: ``extra`` "x2"), with a residual
    (``extra`` "res")."""
    op = tuple(s - 1 for s in stride) if transpose else 0
    layer = cuda_conv3d.layer(_module(
        (lambda: nn.ConvBlock(3, ci, co, stride=stride, transpose=transpose,
                              output_padding=op)) if relu else
        (lambda: nn.Conv(3, ci, co, 3, padding=1, bias=False))))
    return ((lambda x, x2=None, res=None: cuda_conv3d.conv3d_reg(
        x, layer, x2, res)),
        {"stride": layer.stride, "transpose": layer.transpose}, extra)


def _chain(chans):
    """K4's chain (plain version on the CPU) of BN-folded 3x3 layers, with
    ``FeatureNet``'s reach: one row a layer, its own padding at the
    edges."""
    torch.manual_seed(0)
    specs = [(0.3 * torch.randn(co, ci, 3, 3), 0.1 * torch.randn(co))
             for ci, co in zip(chans, chans[1:])]
    return ((lambda t: cuda_conv.conv_bn_relu_chain(t, specs)),
            {"taps": 2 * len(specs) + 1, "clip": True}, None)


def _gru(hd):
    """K2's step (plain version on the CPU) with ``ConvGRU``'s reach."""
    gru = _module(lambda: blocks.ConvGRU(hd, hd))
    return ((lambda h, x: cuda_gru.gru_step(h, x, gru)),
            {"taps": 5, "clip": True}, "gru")


# name: (op factory, input shape with n along the blocked axis, axes)
OPS = {
    "conv2d_3x3": (lambda: _conv(lambda: nn.Conv(2, C, 4, 3, 1, 1)),
                   (B, 10, 7, C), (1,)),
    "conv2d_5x5_stride2": (lambda: _conv(lambda: nn.Conv(2, C, 4, 5, 2, 2)),
                           (B, 12, 7, C), (1,)),
    "conv2d_1x1": (lambda: _conv(lambda: nn.Conv(2, C, 4, 1)),
                   (B, 10, 7, C), (1,)),
    "conv2d_7x7": (lambda: _conv(lambda: nn.Conv(2, 1, 4, 7, padding=3)),
                   (B, 10, 7, 1), (1,)),
    "conv3d_stride1": (lambda: _conv(lambda: nn.ConvBlock(3, C, 4).conv),
                       (B, 8, 8, 5, C), (1, 2)),
    "conv3d_stride2": (lambda: _conv(
        lambda: nn.ConvBlock(3, C, 4, stride=2).conv), (B, 8, 8, 5, C),
        (1, 2)),
    "deconv3d_stride2": (lambda: _conv(lambda: nn.ConvBlock(
        3, C, 4, stride=2, transpose=True, output_padding=1).conv),
        (B, 5, 5, 4, C), (1, 2)),
    "deconv3d_stride122": (lambda: _conv(lambda: nn.ConvBlock(
        3, C, 4, stride=(1, 2, 2), transpose=True,
        output_padding=(0, 1, 1)).conv), (B, 5, 5, 4, C), (1, 2)),
    "reg_stride1": (lambda: _reg(8, 8), (B, 8, 8, 5, 8), (1, 2)),
    "reg_stride2": (lambda: _reg(8, 16, (2, 2, 2)), (B, 8, 8, 5, 8),
                    (1, 2)),
    "reg_stride122": (lambda: _reg(1, 8, (1, 2, 2)), (B, 8, 8, 5, 1),
                      (1, 2)),
    "reg_transposed2": (lambda: _reg(16, 8, (2, 2, 2), True),
                        (B, 5, 5, 4, 16), (1, 2)),
    "reg_transposed122": (lambda: _reg(8, 1, (1, 2, 2), True),
                          (B, 5, 5, 4, 8), (1, 2)),
    "reg_x2": (lambda: _reg(16, 8, extra="x2"), (B, 8, 8, 5, 8), (1, 2)),
    "reg_res": (lambda: _reg(32, 16, (2, 2, 2), True, extra="res"),
                (B, 5, 5, 4, 32), (1, 2)),
    "reg_plain_conv": (lambda: _reg(8, 1, relu=False), (B, 8, 8, 5, 8),
                       (1, 2)),
    "k4_chain": (lambda: _chain((3, 8, 8)), (B, 10, 7, 3), (1,)),
    "k4_chain_3": (lambda: _chain((3, 8, 8, 16)), (B, 12, 7, 3), (1,)),
    "k2_step": (lambda: _gru(16), (B, 10, 7, 16), (1,)),
    "upsample_neighbours": (lambda: (upsample._neighbours, {}, None),
                            (B, 10, 7, 1), (1,)),
}
# block boundaries along an axis of n entries: uneven, and even where a
# stride-2 op needs its blocks to start on even entries
SPLITS = {2: {5: (0, 2, 5), 8: (0, 2, 8), 10: (0, 4, 10), 12: (0, 4, 12)},
          3: {5: (0, 1, 3, 5), 8: (0, 2, 4, 8), 10: (0, 2, 6, 10),
              12: (0, 2, 6, 12)}}


def _cases():
    for name, (_, shape, axes) in OPS.items():
        for axis in axes:
            for parts in (2, 3):
                where = "D" if axis == 1 and len(shape) == 5 else "H"
                yield pytest.param(name, axis, parts,
                                   id=f"{name}-{where}-{parts}")


def _inputs(x, extra):
    """The op's inputs on the whole tensor: x, and h and x for the GRU or
    x and x2 for the fused layer's two halves."""
    if extra == "gru":
        return torch.tanh(x), torch.relu(_seeded(3, *x.shape))
    return (x, _seeded(4, *x.shape)) if extra == "x2" else (x,)


@pytest.mark.parametrize("name,axis,parts", list(_cases()))
def test_an_op_on_blocks_with_halos_is_the_whole_tensors(name, axis, parts):
    """The op on ``parts`` uneven blocks along ``axis`` (D of a volume, or
    the rows), each with the halo ``on_block`` asks for cut from the whole
    tensor zero padded, joined: the whole tensor's output, in fp32 to
    1e-6 of its largest value."""
    make, shape, _ = OPS[name]
    fn, reach, extra = make()
    xs = _inputs(_seeded(1, *shape), extra)
    s = reach.get("stride", 1)
    s = s if isinstance(s, int) else s[axis - 1]
    up = reach.get("transpose", False)
    bounds = SPLITS[parts][shape[axis]]
    with torch.no_grad():
        res = _seeded(5, *fn(*xs).shape) if extra == "res" else None
        want = fn(*xs) if res is None else fn(*xs, res=res)
        outs = []
        for a, b in zip(bounds, bounds[1:]):
            blocks_ = tuple(t.narrow(axis, a, b - a) for t in xs)
            whole = {id(blk): t for blk, t in zip(blocks_, xs)}

            def exchange(t, lo, hi, a=a, b=b, whole=whole):
                pad = (0, 0) * (t.dim() - 1 - axis) + (lo, hi)
                return torch.nn.functional.pad(whole[id(t)], pad).narrow(
                    axis, a, b - a + lo + hi).clone(
                        memory_format=torch.contiguous_format)
            oa, ob = (a * s, b * s) if up else (a // s, b // s)
            rb = None if res is None else res.narrow(axis, oa, ob - oa)
            outs.append(par.on_block(fn, blocks_, axis, exchange,
                                     (a == 0, b == shape[axis]), res=rb,
                                     **reach))
        got = torch.cat(outs, axis)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max())


def test_without_a_policy_the_runner_calls_the_op_on_the_whole_tensor():
    calls = []

    def op(*args, **kw):
        calls.append((args, kw))
        return "out"
    x, x2, res = torch.ones(2, 4, 3, 3, 1), torch.ones(2, 4, 3, 3, 1), None
    with par.depth_blocks(), par.row_blocks():
        assert par.run_blocked(op, x, taps=5, clip=True) == "out"
        assert par.run_blocked(op, x, x2, stride=2, res=x) == "out"
        assert par.run_blocked(op, x, res=res) == "out"
    assert calls[0] == ((x,), {})
    assert calls[1][0] == (x, x2) and calls[1][1]["res"] is x
    assert calls[2] == ((x,), {})


def _misaligned(*shape, dtype=torch.float32):
    """A dense tensor whose start is 4 bytes off 16."""
    n = torch.Size(shape).numel()
    return torch.zeros(n + 1, dtype=dtype)[1:].view(*shape)


def _gru_args(h, x, hd=16):
    gru = blocks.ConvGRU(hd, hd).requires_grad_(False)
    return (h, x, gru.convz.weight, gru.convr.weight, gru.convq.weight,
            gru.convz.bias, gru.convr.bias, gru.convq.bias)


def _chain_specs(chans):
    return [(torch.zeros(co, ci, 3, 3), torch.zeros(co))
            for ci, co in zip(chans, chans[1:])]


def _warp(ref, src=None, C=8):
    """K1's and K3's wrappers on ref (B=1, H=4, W=8) and src."""
    src = torch.zeros(1, 2, 4, 8, C) if src is None else src
    rots = torch.eye(3).expand(1, 2, 3, 3)
    trs = torch.zeros(1, 2, 3)
    depth = torch.ones(1, 3, 4, 8)
    g = torch.zeros(1, 2, 3, 4, 8)
    return [lambda: cuda_warp._views_cuda(ref, src, rots, trs, depth),
            lambda: cuda_warp._views_bwd_cuda(ref, src, rots, trs, depth, g)]


def _layer(ci=8, co=8):
    return cuda_conv3d.layer(nn.ConvBlock(3, ci, co).eval()
                             .requires_grad_(False))


REFUSALS = {
    "k1_k3_dtype": (lambda: _warp(torch.zeros(1, 4, 8, 8,
                                              dtype=torch.float16),
                                  torch.zeros(1, 2, 4, 8, 8,
                                              dtype=torch.float16)),
                    "must share one of"),
    "k1_k3_channels": (lambda: _warp(torch.zeros(1, 4, 8, 12), C=12),
                       "channels must be"),
    "k1_k3_dense": (lambda: _warp(torch.zeros(1, 4, 8, 16)[..., :8]),
                    "dense"),
    "k1_k3_aligned": (lambda: _warp(_misaligned(1, 4, 8, 8)), "aligned"),
    "k1_k3_aligned_per_item": (lambda: _warp(
        torch.zeros(1, 4, 8, 8), torch.zeros(600).as_strided(
            (1, 2, 4, 8, 8), (513, 256, 64, 8, 1))), "per batch item"),
    "k2_dtype": (lambda: [lambda: cuda_gru._gru_cuda(*_gru_args(
        torch.zeros(1, 4, 8, 16, dtype=torch.float16),
        torch.zeros(1, 4, 8, 16, dtype=torch.float16)))], "must share one of"),
    "k2_hidden": (lambda: [lambda: cuda_gru._gru_cuda(*_gru_args(
        torch.zeros(1, 4, 8, 24), torch.zeros(1, 4, 8, 24), 24))],
        "hidden width"),
    "k2_dense": (lambda: [lambda: cuda_gru._gru_cuda(*_gru_args(
        torch.zeros(1, 8, 4, 16).transpose(1, 2),
        torch.zeros(1, 4, 8, 16)))], "dense"),
    "k2_aligned": (lambda: [lambda: cuda_gru._gru_cuda(*_gru_args(
        torch.zeros(1, 4, 8, 16), _misaligned(1, 4, 8, 16)))], "aligned"),
    "k4_dtype": (lambda: [lambda: cuda_conv._chain_cuda(
        torch.zeros(1, 4, 8, 8, dtype=torch.float64),
        _chain_specs((8, 8, 8)), None)], "must share one of"),
    "k4_chain": (lambda: [lambda: cuda_conv._chain_cuda(
        torch.zeros(1, 4, 8, 4), _chain_specs((4, 8, 8)), None)],
        "not one the kernel"),
    "k4_dense": (lambda: [lambda: cuda_conv._chain_cuda(
        torch.zeros(1, 8, 4, 8).transpose(1, 2), _chain_specs((8, 8, 8)),
        None)], "dense"),
    "k4_aligned": (lambda: [lambda: cuda_conv._chain_cuda(
        _misaligned(1, 4, 8, 8), _chain_specs((8, 8, 8)), None)],
        "aligned"),
    "conv3d_reg_dtype": (lambda: [lambda: cuda_conv3d._reg_cuda(
        torch.zeros(1, 4, 4, 4, 8, dtype=torch.float16), _layer(),
        None, None)], "must share one of"),
    "conv3d_reg_dense": (lambda: [lambda: cuda_conv3d._reg_cuda(
        torch.zeros(1, 4, 4, 4, 8), _layer(), None,
        torch.zeros(1, 4, 4, 8, 4).transpose(3, 4))], "dense"),
    "conv3d_reg_aligned": (lambda: [lambda: cuda_conv3d._reg_cuda(
        _misaligned(1, 4, 4, 4, 8), _layer(), None, None)], "aligned"),
    "conv3d_reg_channels": (lambda: [lambda: cuda_conv3d.conv3d_reg(
        torch.zeros(1, 4, 4, 4, 4), _layer())], "channels"),
    "conv3d_reg_weights": (lambda: [lambda: cuda_conv3d._reg_cuda(
        torch.zeros(1, 4, 4, 4, 8), _layer()._replace(
            weight=torch.zeros(8, 8, 3, 3, 3, dtype=torch.float64)),
        None, None)], "fp32"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_every_wrapper_still_refuses_what_its_kernel_does_not_take(case):
    """Each wrapper's own checks raise ValueError before the launch path
    (CPU tensors: a check that let them through would reach
    ``_kernels.launch``, which builds the library with nvcc)."""
    calls, match = REFUSALS[case]
    for call in calls():
        with pytest.raises(ValueError, match=match):
            call()
