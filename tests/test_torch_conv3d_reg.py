"""The fused 3-D layers' plain version (``ops/cuda_conv3d.py``) on the CPU:
against the modules' layer-by-layer path for every layer kind of
``CostRegNet`` and ``CSPBlock``, both modules' fused path on the shipped
DTU weights, the layer's operands, and where the fused path
engages (``blocks.reg_applies``).  The kernel itself is held to the plain
version on the card by ``tests/test_torch_conv3d_reg_cuda.py``."""

import types
from pathlib import Path

import pytest
import torch

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.ops import cuda_conv3d
from effi_mvs_plus_tpu_torch.ops.rounding_bounds import NOISE, _U
from effi_mvs_plus_tpu_torch.parallel import mesh as par
from effi_mvs_plus_tpu_torch.utils import profiling

NPZ = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "model_dtu.npz"
# kind: (input channels, output channels, stride, transposed, relu, input
# (D, H, W), two inputs, residual)
KINDS = {
    "stride1": (8, 8, 1, False, True, (6, 10, 9), False, False),
    "stride2": (8, 16, 2, False, True, (6, 10, 9), False, False),
    "stride122": (1, 8, (1, 2, 2), False, True, (4, 10, 9), False, False),
    "transposed2": (16, 8, 2, True, True, (3, 5, 4), False, False),
    "transposed122": (8, 1, (1, 2, 2), True, True, (4, 5, 4), False, False),
    "cat": (16, 8, 1, False, True, (4, 10, 9), True, False),
    "residual": (32, 16, 2, True, True, (3, 5, 4), False, True),
    "cout1": (8, 1, 1, False, False, (6, 10, 9), False, False),
}


def _block(kind, seed=0):
    ci, co, stride, tr, relu, _, _, _ = KINDS[kind]
    torch.manual_seed(seed)
    op = tuple(s - 1 for s in par_triple(stride)) if tr else 0
    if not relu:
        return nn.Conv(3, ci, co, 3, padding=1, bias=False).eval()
    blk = nn.ConvBlock(3, ci, co, stride=stride, transpose=tr,
                       output_padding=op).eval()
    with torch.no_grad():
        blk.bn.running_mean.uniform_(-0.5, 0.5)
        blk.bn.running_var.uniform_(0.5, 2.0)
        blk.bn.weight.uniform_(0.5, 1.5)
        blk.bn.bias.uniform_(-0.5, 0.5)
    return blk


def par_triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _inputs(kind, dtype, layer, seed=1):
    ci, _, _, _, _, (D, H, W), two, res = KINDS[kind]
    g = torch.Generator().manual_seed(seed)
    c = ci // 2 if two else ci
    x = torch.randn((2, D, H, W, c), generator=g).to(dtype)
    x2 = torch.randn((2, D, H, W, c), generator=g).to(dtype) if two else None
    r = torch.randn(cuda_conv3d.out_shape(x, layer), generator=g).to(dtype) \
        if res else None
    return x, x2, r


def layer_gap_bound(x, layer, x2=None, res=None):
    """(exact, bound) for one fused 3-D layer (``cuda_conv3d.Layer``) on
    x (and x2, res) of dtype dt, in float64: ``exact`` the layer's value
    on the inputs and the weights rounded to dt, and ``bound`` how far
    the modules' op-by-op path in dt (conv, BN's scale and shift rounded
    to dt, product, sum, residual add, each rounded) may lie from the
    fused arithmetic (one rounding at the end, ``cuda_conv3d``).  Each
    rounding adds at most u = 2^-8 (bf16; 2^-24 fp32) of the value it
    rounds, the conv's a factor |scale| later; the fp32 sums add NOISE
    units of 2^-24 of the summed magnitudes (``ops/rounding_bounds.py``)."""
    dt = x.dtype
    u = 2.0 ** -8 if dt == torch.bfloat16 else _U
    xin = x if x2 is None else torch.cat([x, x2], -1)

    def conv(v, w):
        v = v.movedim(-1, 1)
        if layer.transpose:
            y = torch.nn.functional.conv_transpose3d(
                v, w, None, layer.stride, 1,
                tuple(s - 1 for s in layer.stride))
        else:
            y = torch.nn.functional.conv3d(v, w, None, layer.stride, 1)
        return y.movedim(1, -1)
    w = layer.weight.to(dt).double()
    c = conv(xin.double(), w)
    mag = conv(xin.double().abs(), w.abs())
    scale, shift = (t.double() for t in layer.affine())
    pre = c * scale + shift
    y = torch.relu(pre) if layer.relu else pre
    out = y if res is None else y + res.double()
    bound = ((4 * u + NOISE * _U) * mag * scale.abs() + 2 * u * shift.abs()
             + 2 * u * out.abs())
    return out, bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_version_matches_the_layer_by_layer_path(kind, dtype):
    """The fused arithmetic against the module's own layers (the cat and
    the residual add as ``CSPBlock`` and ``CostRegNet`` write them), in
    x's dtype: both within ``layer_gap_bound`` (fp32:
    the sums' noise; bf16: the op-by-op path's roundings), and the fused
    value within one rounding of the exact one."""
    blk = _block(kind)
    layer = cuda_conv3d.layer(blk)
    x, x2, res = _inputs(kind, dtype, layer)
    with torch.no_grad():
        xin = x if x2 is None else torch.cat([x, x2], -1)
        want = blk(xin)
        if res is not None:
            want = res + want
        got = cuda_conv3d.conv3d_reg(x, layer, x2, res)
        exact, bound = layer_gap_bound(x, layer, x2, res)
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= bound + 1e-12).all()), float((gap - bound).max())
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
    assert bool(((got.double() - exact).abs()
                 <= u * exact.abs() + 1e-6 * exact.abs().max()).all())


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_layer_reads_the_modules_own_tensors(kind):
    """``layer`` keeps the module's weight and BN (no copy, nothing
    packed), and its affine is BN's running-statistic scale and shift as
    ``nn.batch_norm`` computes them in eval mode (ones and zeros for the
    plain convolution)."""
    blk = _block(kind)
    layer = cuda_conv3d.layer(blk)
    conv = blk.conv if isinstance(blk, nn.ConvBlock) else blk
    assert layer.weight.data_ptr() == conv.weight.data_ptr()
    assert not layer.weight.requires_grad
    scale, shift = layer.affine()
    y = torch.randn(3, 4, layer.channels[1])
    with torch.no_grad():
        want = blk.bn(y) if isinstance(blk, nn.ConvBlock) else y
    assert torch.allclose(y * scale + shift, want, rtol=1e-6, atol=1e-6)


def on_blocks(layer, x, x2, res, axis, split):
    """``parallel.on_block`` with one fused layer on the blocks [0, split)
    and [split, n) of x (and x2) along ``axis``, each given its halo cut
    from the whole tensor padded with zeros, in a new contiguous tensor
    (as ``parallel.halo`` hands it), and the residual's blocks; the
    outputs joined."""
    n, s = x.shape[axis], layer.stride[axis - 1]
    outs = []
    for a, b in ((0, split), (split, n)):
        xb = x.narrow(axis, a, b - a)
        x2b = None if x2 is None else x2.narrow(axis, a, b - a)
        whole = {id(xb): x, id(x2b): x2}

        def halo(t, lo, hi, a=a, b=b, whole=whole):
            pad = (0, 0) * (4 - axis) + (lo, hi)
            return torch.nn.functional.pad(whole[id(t)], pad).narrow(
                axis, a, b - a + lo + hi).clone(
                    memory_format=torch.contiguous_format)
        oa, ob = (a * s, b * s) if layer.transpose else (a // s, b // s)
        rb = None if res is None else res.narrow(axis, oa, ob - oa)
        outs.append(par.on_block(
            lambda x, x2, res=None: cuda_conv3d.conv3d_reg(x, layer, x2, res),
            (xb, x2b), axis, halo, (a == 0, b == n), stride=layer.stride,
            transpose=layer.transpose, res=rb))
    return torch.cat(outs, axis)


@pytest.mark.parametrize("axis", [1, 2], ids=["depth", "rows"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_a_layer_on_blocks_with_halos_is_the_whole_volumes(kind, axis):
    """Each layer kind on two blocks of the volume along D or H (a depth
    or a spatial policy's blocks), each with the halo ``parallel.on_block``
    asks for, joined: the whole volume's output, in fp32 to 1e-6 of its
    largest value."""
    blk = _block(kind)
    layer = cuda_conv3d.layer(blk)
    x, x2, res = _inputs(kind, torch.float32, layer)
    with torch.no_grad():
        want = cuda_conv3d.conv3d_reg(x, layer, x2, res)
        got = on_blocks(layer, x, x2, res, axis, 2)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def _shipped(kind):
    """The DTU checkpoint's CostRegNet or CSP_R1, eval, fp32, on the CPU."""
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    sd = load_state_dict(str(NPZ))
    prefix = "cost_regularization." if kind == "reg" else "CSP_R1."
    m = blocks.CostRegNet() if kind == "reg" else blocks.CSPBlock()
    m.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                       if k.startswith(prefix)}, strict=True)
    return m.eval()


def _volumes(kind, dtype):
    g = torch.Generator().manual_seed(7)
    if kind == "reg":
        return (torch.rand((1, 16, 12, 20, 1), generator=g).to(dtype),)
    return (torch.rand((1, 8, 16, 20, 1), generator=g).to(dtype),
            torch.rand((1, 8, 8, 10, 1), generator=g).to(dtype))


def _run(m, vols, fused, monkeypatch, calls=None):
    """m on vols through the fused path (the gate forced open on the CPU)
    or the blocks; ``calls`` counts conv3d_reg's calls."""
    monkeypatch.setattr(blocks, "reg_applies",
                        lambda x, training: fused)
    orig = cuda_conv3d.conv3d_reg

    def counted(*a, **kw):
        if calls is not None:
            calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(cuda_conv3d, "conv3d_reg", counted)
    with torch.no_grad():
        out = m(*vols)
    monkeypatch.setattr(cuda_conv3d, "conv3d_reg", orig)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kind", ["reg", "csp"])
def test_fused_modules_match_the_blocks_on_the_shipped_weights(kind,
                                                                monkeypatch):
    """fp32: the fused path is the blocks' to 1e-5 of the outputs' size;
    bf16: it rounds once a layer where the blocks round after each op, so
    it lies no farther from the fp32 blocks than the bf16 blocks do.  9
    layers (CostRegNet) or 4 (CSPBlock), one call each, and no launch
    counted on the CPU."""
    m = _shipped(kind)
    vols = _volumes(kind, torch.float32)
    n0 = profiling.counter("conv3d_reg.launches")
    calls = []
    fused = _run(m, vols, True, monkeypatch, calls)
    blocks_ = _run(m, vols, False, monkeypatch)
    assert len(calls) == (9 if kind == "reg" else 4)
    assert profiling.counter("conv3d_reg.launches") == n0
    for a, b in zip(fused, blocks_):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    vols16 = _volumes(kind, torch.bfloat16)
    fused16 = _run(m, vols16, True, monkeypatch)
    blocks16 = _run(m, vols16, False, monkeypatch)
    for a, b, ref in zip(fused16, blocks16, blocks_):
        assert a.dtype == b.dtype == torch.bfloat16

        def rel(t):
            return float((t.double() - ref.double()).norm()
                         / ref.double().norm())
        assert rel(a) <= rel(b), (rel(a), rel(b))


def _fake(is_cuda=True):
    return types.SimpleNamespace(is_cuda=is_cuda)


@pytest.mark.parametrize("case", ["served", "cpu", "grad", "training",
                                  "depth_policy", "row_policy"])
def test_the_fused_path_engages_only_where_it_may(case):
    """On the card in eval mode with grad off, on the whole volume and on
    a block of it (a depth or a spatial policy, where each layer takes
    its halo: the rank checks of tests/test_torch_parallel_depth.py and
    tests/test_torch_parallel_spatial.py); not on the CPU, with grad on
    or in training."""
    x = _fake(case != "cpu")
    training = case == "training"
    depth = par.ShardingPolicy(par.Mesh(1, 2), shard_views=False,
                               shard_depth=True)
    rows = par.ShardingPolicy(par.Mesh(1, 2), shard_views=False,
                              shard_spatial=True)
    with torch.set_grad_enabled(case == "grad"):
        if case == "depth_policy":
            with par.use_policy(depth), par.depth_blocks():
                assert par._blocked()[1] == "depth"
                got = blocks.reg_applies(x, training)
        elif case == "row_policy":
            with par.use_policy(rows), par.image_rows(128), par.row_blocks():
                assert par._blocked()[1] == "rows"
                got = blocks.reg_applies(x, training)
        else:
            got = blocks.reg_applies(x, training)
    assert got == (case in ("served", "depth_policy", "row_policy"))


@pytest.mark.parametrize("case", ["cpu", "grad", "training"])
def test_the_layer_by_layer_path_runs_where_the_gate_is_shut(case,
                                                            monkeypatch):
    """CostRegNet and CSPBlock on the CPU, also with grad on and in
    training mode, never call conv3d_reg and count no launch."""
    calls = []
    orig = cuda_conv3d.conv3d_reg

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(cuda_conv3d, "conv3d_reg", counted)
    n0 = profiling.counter("conv3d_reg.launches")
    for kind in ("reg", "csp"):
        m = _shipped(kind)
        if case == "training":
            m.train()
        with torch.set_grad_enabled(case != "cpu"):
            m(*_volumes(kind, torch.float32))
    assert calls == []
    assert profiling.counter("conv3d_reg.launches") == n0


def test_a_layer_the_kernel_lacks_is_refused():
    """A 5x5x5 layer, padding 0 or a bias is not one conv3d_reg takes."""
    with pytest.raises(ValueError, match="3x3x3"):
        cuda_conv3d.layer(nn.ConvBlock(3, 8, 8, k=5, padding=2))
    with pytest.raises(ValueError, match="3x3x3"):
        cuda_conv3d.layer(nn.ConvBlock(3, 8, 8, padding=0))
    with pytest.raises(ValueError, match="no bias"):
        cuda_conv3d.layer(nn.Conv(3, 8, 8, 3, padding=1))
    blk = _block("stride1")
    layer = cuda_conv3d.layer(blk)
    with pytest.raises(ValueError, match="channels"):
        cuda_conv3d.conv3d_reg(torch.zeros(1, 4, 4, 4, 4), layer)
    with pytest.raises(ValueError, match="inference only"):
        cuda_conv3d.conv3d_reg(torch.zeros(1, 4, 4, 4, 8,
                                           requires_grad=True), layer)
