"""The arithmetic the K2 and K4 kernels are built to, on the CPU.

* ``cuda_gru._gru_reference`` (the TPU kernel's rounding points in plain
  PyTorch, which the card's checks hold K2 to) against the JAX package's
  Pallas GRU kernel in interpret mode: in bf16 equal but in at most 1e-3
  of the outputs, and there by at most one bf16 ulp of the value (both
  sum fp32 products in their own order, so a value that lies on a
  rounding boundary may round either way); in fp32 within max 5e-4 and
  mean 5e-6 (tests/test_torch_gru.py's bound); and equal to ``_gru_torch``
  in fp32 within 1e-5.
* The packed weight layouts (``ops/conv_pack.py``): the weights are read
  back from the packed bytes in the order and at the places the kernels
  read them (units, k16 steps, mma fragment registers, the zero tenth
  tap, the padded input channels), and the tap sum over them equals
  ``F.conv2d`` on the original weights (float64, 1e-12), for each K2
  width and each chain of ``cuda_conv.CHAINS``, both dtypes.
* ``ops/_kernels.py`` builds from every file under ``csrc/``, and the
  profile scripts count each of its kernels in a kernel class.
* ``ops/rounding_bounds.py``, the range of bf16 results the card's checks
  accept: it holds two fp32 summation orders of the same arithmetic, is
  the exact value away from rounding boundaries, and refuses a wrong
  output.
* ``models.freeze_kernel_weights``: a frozen ConvGRU or FPN folds and packs
  once per dtype and computes what an unfrozen one does."""

import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from effi_mvs_plus_tpu.ops import pallas_gru as pg
from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.models import blocks, freeze_kernel_weights
from effi_mvs_plus_tpu_torch.models.blocks import ConvGRU
from effi_mvs_plus_tpu_torch.ops import (_kernels, conv_pack, cuda_conv,
                                         cuda_gru, rounding_bounds)

GRU_SHAPES = [(2, 11, 13, 16), (1, 40, 12, 32), (2, 7, 9, 48)]


def _gru_inputs(B, H, W, hd, seed):
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.standard_normal((B, H, W, hd))).astype(np.float32)
    x = rng.standard_normal((B, H, W, hd)).astype(np.float32)
    p = {k: {"weight": (rng.standard_normal((3, 3, 2 * hd, hd)) * 0.1
                        ).astype(np.float32),
             "bias": (rng.standard_normal(hd) * 0.1).astype(np.float32)}
         for k in ("convz", "convr", "convq")}
    return h, x, p


def _torch_args(h, x, p, dtype):
    w = [torch.from_numpy(np.ascontiguousarray(p[k]["weight"].transpose(3, 2, 0, 1)))
         for k in ("convz", "convr", "convq")]
    b = [torch.from_numpy(p[k]["bias"]) for k in ("convz", "convr", "convq")]
    return (torch.from_numpy(h).to(dtype), torch.from_numpy(x).to(dtype),
            *w, *b)


def _pallas(h, x, p, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in p.items()}
    out = pg.gru_step(jnp.asarray(h).astype(jdt), jnp.asarray(x).astype(jdt),
                      jp, impl="pallas", interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("B,H,W,hd", GRU_SHAPES)
def test_gru_reference_rounds_as_the_tpu_kernel_bf16(B, H, W, hd):
    h, x, p = _gru_inputs(B, H, W, hd, seed=hd)
    got = cuda_gru._gru_reference(*_torch_args(h, x, p, torch.bfloat16))
    got = got.float().numpy()
    want = _pallas(h, x, p, torch.bfloat16)
    differ = got != want
    assert differ.mean() <= 1e-3, differ.mean()
    big = np.maximum(np.abs(got), np.abs(want))[differ]
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert (np.abs(got - want)[differ] <= ulp).all()


@pytest.mark.parametrize("B,H,W,hd", GRU_SHAPES)
def test_gru_reference_matches_the_tpu_kernel_fp32(B, H, W, hd):
    h, x, p = _gru_inputs(B, H, W, hd, seed=hd + 1)
    args = _torch_args(h, x, p, torch.float32)
    got = cuda_gru._gru_reference(*args).numpy()
    d = np.abs(got - _pallas(h, x, p, torch.float32))
    assert d.max() < 5e-4 and d.mean() < 5e-6, (d.max(), d.mean())
    plain = cuda_gru._gru_torch(*args).numpy()
    assert np.abs(got - plain).max() <= 1e-5
    unrounded = cuda_gru._gru_reference(*args, rounded=False).numpy()
    np.testing.assert_array_equal(got, unrounded)


def test_gru_reference_rounds_only_at_the_end_when_asked():
    h, x, p = _gru_inputs(1, 6, 7, 16, seed=3)
    args = _torch_args(h, x, p, torch.bfloat16)
    out = cuda_gru._gru_reference(*args)
    pre = cuda_gru._gru_reference(*args, rounded=False)
    assert out.dtype == torch.bfloat16 and pre.dtype == torch.float32
    torch.testing.assert_close(pre.to(torch.bfloat16), out, rtol=0, atol=0)


# ---- packed weights, read back the kernels' way ----

def _unit_bytes(ci, co, dtype):
    """Bytes of one unit (tap or tap pair) of a layer: the kernels'
    Layer::UB (csrc/conv_chain.cu) and Gru::SZ1/SZ2 (csrc/conv_gru.cu)."""
    if conv_pack.mma_route(dtype, ci, co):
        return (1 if ci == 8 else ci // 16) * (co // 8) * 256
    return -(-ci // 4) * 4 * co * 4


def _read_back(packed, ci, co, dtype):
    """The dense (co, ci, 9) weights a layer's kernel sees, gathered from
    its packed units in the kernel's read order; also checks that every
    weight is read once and every other packed value is zero."""
    mma = conv_pack.mma_route(dtype, ci, co)
    sb = _unit_bytes(ci, co, dtype)
    taps = conv_pack.unit_taps(ci, mma)
    assert packed.numel() == sb * len(taps)
    dense = np.zeros((co, ci, 10))
    seen = np.zeros((co, ci, 10), int)
    for s, taps_s in enumerate(taps):
        chunk = packed[s * sb:(s + 1) * sb]
        if mma:
            # [k-step][n-tile][lane][b0, b1][2 bf16]: lane l, register r,
            # half e holds output channel 8n + l // 4 at k16 row
            # 2 (l % 4) + e + 8 r; rows 0-7 come from the ldmatrix
            # addresses of lanes 0-15, rows 8-15 from lanes 16-31
            vals = chunk.view(torch.bfloat16).double().numpy()
            ksteps = 1 if ci == 8 else ci // 16
            vals = vals.reshape(ksteps, co // 8, 32, 2, 2)
            for kk in range(ksteps):
                for n in range(co // 8):
                    for lane in range(32):
                        for r in range(2):
                            for e in range(2):
                                j = 2 * (lane % 4) + e + 8 * r
                                tap = taps_s[j // 8]
                                ch = j % 8 if ci == 8 else kk * 16 + j
                                o = 8 * n + lane // 4
                                dense[o, ch, tap] += vals[kk, n, lane, r, e]
                                seen[o, ch, tap] += 1
        else:
            ci4 = -(-ci // 4) * 4
            vals = chunk.view(torch.float32).double().numpy().reshape(ci4, co)
            assert (vals[ci:] == 0).all()
            dense[:, :, taps_s] = vals[:ci].T
            seen[:, :, taps_s] += 1
    assert (seen[:, :, :9] == 1).all() and (dense[:, :, 9] == 0).all()
    return dense[:, :, :9]


def _tap_sum(x, dense):
    """3x3 pad-1 convolution of x (B,H,W,ci) as the kernels form it: for
    each tap, the input shifted by the tap times that tap's weights."""
    B, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = 0
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        out = out + torch.einsum("bhwc,oc->bhwo", xp[:, dy:dy + H, dx:dx + W],
                                 torch.from_numpy(dense[:, :, tap]))
    return out


def _conv(x, w, dtype):
    w = w.to(dtype).double()
    return F.conv2d(x.movedim(-1, 1), w, padding=1).movedim(1, -1)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("hd", [16, 32, 48])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gru_packed_weights_read_back_as_the_convolutions(hd, dtype):
    g = torch.Generator().manual_seed(hd)
    wz, wr, wq = (torch.randn((hd, 2 * hd, 3, 3), generator=g)
                  for _ in range(3))
    packed = cuda_gru.pack_weights(wz, wr, wq, dtype)
    x = torch.randn((1, 5, 6, 2 * hd), generator=g, dtype=torch.float64)
    # the kernel's units: r's 9 taps and z's (2hd in), q's r*h half's and
    # q's x half's (hd in), in that order
    sb2 = _unit_bytes(2 * hd, hd, dtype)
    sb1 = _unit_bytes(hd, hd, dtype)
    assert packed.numel() == 18 * sb2 + 18 * sb1
    segs = [(packed[:9 * sb2], 2 * hd, wr), (packed[9 * sb2:18 * sb2], 2 * hd, wz),
            (packed[18 * sb2:18 * sb2 + 9 * sb1], hd, wq[:, :hd]),
            (packed[18 * sb2 + 9 * sb1:], hd, wq[:, hd:])]
    for chunk, ci, w in segs:
        got = _tap_sum(x[..., :ci], _read_back(chunk, ci, hd, dtype))
        torch.testing.assert_close(got, _conv(x[..., :ci], w, dtype),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chans", cuda_conv.CHAINS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_packed_weights_read_back_as_the_convolutions(chans, dtype):
    g = torch.Generator().manual_seed(sum(chans))
    specs = [(torch.randn((co, ci, 3, 3), generator=g), torch.zeros(co))
             for ci, co in zip(chans[:-1], chans[1:])]
    packed = cuda_conv.pack_weights(specs, dtype)
    start = 0
    for (w, _), ci, co in zip(specs, chans[:-1], chans[1:]):
        n = _unit_bytes(ci, co, dtype) * len(
            conv_pack.unit_taps(ci, conv_pack.mma_route(dtype, ci, co)))
        x = torch.randn((2, 4, 7, ci), generator=g, dtype=torch.float64)
        got = _tap_sum(x, _read_back(packed[start:start + n], ci, co, dtype))
        torch.testing.assert_close(got, _conv(x, w, dtype), rtol=1e-12,
                                   atol=1e-12)
        start += n
    assert start == packed.numel()


def test_chain_routes_follow_the_channel_counts():
    """bf16 layers of 8+ channels on the tensor cores, the rest on the CUDA
    cores, as csrc/conv_chain.cu's Layer::MMA."""
    bf, f32 = torch.bfloat16, torch.float32
    assert conv_pack.mma_route(bf, 8, 8) and conv_pack.mma_route(bf, 64, 64)
    assert not conv_pack.mma_route(bf, 3, 8)
    assert not conv_pack.mma_route(bf, 4, 4)
    assert not conv_pack.mma_route(f32, 64, 64)
    with pytest.raises(ValueError):
        conv_pack.pack(torch.zeros((8, 24, 3, 3)), bf)


def test_kernel_build_covers_every_source_file():
    on_disk = {p.name for p in _kernels.CSRC.iterdir() if p.is_file()}
    assert set(_kernels.SOURCES + _kernels.HEADERS) == on_disk


def test_profiles_classify_every_kernel():
    """scripts/torch_profile_dtu.py (and _train.py, which imports it)
    count every __global__ function under csrc/ in a kernel class."""
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
    from torch_profile_dtu import classify
    names = set()
    for f in _kernels.SOURCES:
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                (_kernels.CSRC / f).read_text()))
    assert len(names) >= 6
    assert {n: classify(n + "<float, 32>") for n in names
            if classify(n + "<float, 32>") == "other"} == {}


@pytest.mark.parametrize("row0", [0, 3])
def test_warp_bound_counts_the_texels_the_taps_reach(row0):
    """chip_smoke.py's K1/K3 bounds read the source texels that the
    in-image bilinear taps reach, counted once per batch and view: the
    same count as a set of (x, y) built tap by tap."""
    import math
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1]))
    import chip_smoke
    from effi_mvs_plus_tpu_torch.core import geometry
    torch.manual_seed(0)
    B, V, D, h, w, H = 2, 3, 4, 6, 9, 12
    rots = torch.eye(3).repeat(B, V, 1, 1) + 0.05 * torch.randn(B, V, 3, 3)
    trs = torch.randn(B, V, 3)
    depth = 5 + torch.rand(B, D, h, w)
    want = 0
    for v in range(V):
        px, py = geometry.project_to_src(rots[:, v], trs[:, v], depth, h, w,
                                         row0)
        for b in range(B):
            seen = {(math.floor(x) + ox, math.floor(y) + oy)
                    for x, y in zip(px[b].flatten().tolist(),
                                    py[b].flatten().tolist())
                    for ox in (0, 1) for oy in (0, 1)}
            want += sum(0 <= x < w and 0 <= y < H for x, y in seen)
    got = chip_smoke.tapped_texels(torch, geometry, rots, trs, depth, H, w,
                                   row0)
    assert 0 < got == want < B * V * H * w


# ---- the range of bf16 results the checks on the card accept ----

def _f64_orders(fn):
    """fn(conv) run with fp32 convolutions (cuDNN's or the CPU's order) and
    with float64 ones rounded to fp32 (nearer the exact sum)."""
    def f64(x, w, b=None, padding=1):
        return nn.conv2d(x.double(), w.double(), b if b is None else
                         b.double(), padding=padding).float()
    return fn(nn.conv2d), fn(f64)


def _gru_with(conv, h, x, wz, wr, wq, bz, br, bq):
    """``_gru_reference(rounded=False)``'s arithmetic with its convolutions
    done by ``conv``."""
    dt, hd = h.dtype, h.shape[-1]
    hf, xf = h.float(), x.float()
    zr = torch.sigmoid(conv(torch.cat([hf, xf], -1),
                            torch.cat([wz, wr]).to(dt).float(),
                            torch.cat([bz, br]).float(), padding=1))
    z, r = zr[..., :hd], zr[..., hd:]
    rh = (r * hf).to(dt).float()
    q = torch.tanh(conv(torch.cat([rh, xf], -1), wq.to(dt).float(),
                        bq.float(), padding=1))
    return hf + z * (q - hf)


def _chain_with(conv, x, specs):
    y = x
    for w, b in specs:
        y = torch.relu(conv(y.float(), w.to(x.dtype).float(), b.float(),
                            padding=1)).to(x.dtype)
    return y


def _outside(got, lo, hi, tol):
    g = got.double()
    return (lo - g).clamp(min=0) + (g - hi).clamp(min=0) - tol


def _assert_local_and_strict(good, lo, hi, tol):
    """The range is wider than the tolerance on under 2% of the outputs,
    and within a tenth of it on most; an output moved by twice the
    tolerance where the range is narrow falls outside."""
    assert ((hi - lo) > tol).double().mean() < 2e-2
    narrow = ((hi - lo) < 0.1 * tol).flatten()
    assert narrow.double().mean() > 0.5
    bad = good.clone()
    i = int(narrow.nonzero()[0])
    bad.view(-1)[i] += 2 * float(tol.flatten()[i])
    assert (_outside(bad, lo, hi, tol) > 0).any()


@pytest.mark.parametrize("hd", [16, 32, 48])
def test_gru_bounds_hold_two_fp32_orders_and_stay_local(hd):
    """Two fp32 summation orders of the TPU kernel's bf16 arithmetic both
    lie within the check's tolerance of ``gru_bounds``' range, even where
    they round an r*h apart; the range is wider than the tolerance on
    under 2% of the outputs, and an output off by twice the tolerance
    where it is narrow is refused."""
    h, x, p = _gru_inputs(1, 48, 64, hd, seed=10 + hd)
    h, x, *w = _torch_args(np.tanh(h), np.maximum(x, 0), p, torch.bfloat16)
    a, b = _f64_orders(lambda conv: _gru_with(conv, h, x, *w))
    lo, hi, two = rounding_bounds.gru_bounds(h, x, *w)
    tol = 1e-4 + 2.0 ** -8 * a.abs().double()
    assert two > 0 and (lo <= hi).all()
    for got in (a, b):
        assert (_outside(got, lo, hi, tol) <= 0).all()
    _assert_local_and_strict(a, lo, hi, tol)


@pytest.mark.parametrize("chans", [(3, 8, 8), (16, 16, 16), (64, 64, 64),
                                   (3, 8, 8, 16)])
def test_chain_bounds_hold_two_fp32_orders_and_stay_local(chans):
    """As for K2, for K4's per-layer bf16 rounding: both fp32 orders lie
    within the check's tolerance of ``chain_bounds``' range, which stays
    narrow."""
    g = torch.Generator().manual_seed(sum(chans))
    x = torch.rand((2, 40, 56, chans[0]), generator=g).bfloat16()
    specs = [((2.0 / (9 * ci)) ** 0.5 * torch.randn((co, ci, 3, 3),
                                                    generator=g),
              0.1 * torch.randn((co,), generator=g))
             for ci, co in zip(chans[:-1], chans[1:])]
    a, b = _f64_orders(lambda conv: _chain_with(conv, x, specs))
    lo, hi, two = rounding_bounds.chain_bounds(x, specs)
    torch.testing.assert_close(a, cuda_conv._chain_torch(x, specs),
                               rtol=0, atol=0)
    tol = (5e-5 + (len(chans) - 1) * 2.0 ** -8) * a.float().abs().clamp(
        min=1.0).double()
    assert two > 0 and (lo <= hi).all()
    for got in (a, b):
        assert (_outside(got, lo, hi, tol) <= 0).all()
    _assert_local_and_strict(a.float(), lo, hi, tol)


def test_bounds_collapse_to_the_reference_in_exact_arithmetic():
    """With NOISE 0 no value has two roundings: the range is the float64
    reference, which the fp32 reference matches to fp32 accuracy."""
    h, x, p = _gru_inputs(1, 9, 11, 16, seed=4)
    args = _torch_args(h, x, p, torch.bfloat16)
    saved = rounding_bounds.NOISE
    rounding_bounds.NOISE = 0
    try:
        lo, hi, two = rounding_bounds.gru_bounds(*args)
    finally:
        rounding_bounds.NOISE = saved
    want = cuda_gru._gru_reference(*args, rounded=False).double()
    assert torch.equal(lo, hi) and two == 0
    differ = (lo - want).abs() > 1e-5
    # where they differ, the fp32 reference rounded an r*h the other way
    assert differ.double().mean() < 1e-2


# ---- weights packed once where they are frozen ----

def test_frozen_gru_packs_once_per_dtype_and_matches():
    torch.manual_seed(0)
    gru = ConvGRU(16, 16).eval()
    h = torch.tanh(torch.randn((1, 6, 9, 16)))
    x = torch.randn((1, 6, 9, 16))
    with torch.no_grad():
        want = gru(h, x)
        freeze_kernel_weights(gru)
        got = gru(h, x)
        first = gru.frozen[torch.float32]
        gru(h, x)
        gru(h.bfloat16(), x.bfloat16())
    assert gru.frozen[torch.float32] is first
    assert set(gru.frozen) == {torch.float32, torch.bfloat16}
    assert first.dtype == torch.float32
    torch.testing.assert_close(first.weights,
                               cuda_gru.pack(gru, torch.float32).weights,
                               rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not any(p.requires_grad for p in gru.parameters())


def test_frozen_stem_folds_and_packs_once_per_level(monkeypatch):
    """The FPN's fused path (forced on the CPU) folds every level's BN at
    every forward, unless frozen: then once per level and dtype."""
    monkeypatch.setattr(blocks, "stem_chain_applies", lambda x, t: True)
    torch.manual_seed(1)
    net = blocks.FeatureNet((8, 16, 32, 64), (32, 16, 8)).eval()
    img = torch.rand((1, 32, 48, 3))
    folds = []
    real = cuda_conv.fold_bn
    monkeypatch.setattr(cuda_conv, "fold_bn",
                        lambda *a: folds.append(1) or real(*a))
    with torch.no_grad():
        want = net(img)
        net(img)
        assert len(folds) == 2 * 8         # 2 stride-1 blocks a level
        freeze_kernel_weights(net)
        for _ in range(3):
            got = net(img)
    assert len(folds) == 3 * 8 and len(net.frozen) == 4
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_packed_operands_are_refused_for_another_dtype():
    specs = [(torch.randn((8, 8, 3, 3)), torch.zeros(8))]
    packed = cuda_conv.pack(specs, torch.bfloat16)
    assert packed.weights.dtype == torch.uint8 and packed.bias.dtype == torch.float32
    with pytest.raises(ValueError, match="packed for"):
        packed.check(torch.float32, torch.device("cpu"))
    packed.check(torch.bfloat16, torch.device("cpu"))
