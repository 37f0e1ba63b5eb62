"""The port's CUDA kernels (K1, K2, K3 the warp's backward, K4 the stem
chain) against their plain versions on the card, at small shapes.  Marked
``cuda``: without a GPU every test skips.  On a GPU machine:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(tests/conftest.py imports JAX).  This file imports no JAX, so it runs
where only PyTorch is installed."""

import pytest
import torch

from effi_mvs_plus_tpu_torch.models.blocks import (ConvGRU, FeatureNet,
                                                  freeze_kernel_weights)
from effi_mvs_plus_tpu_torch.ops import (cuda_conv, cuda_gru, cuda_warp,
                                         rounding_bounds)
from effi_mvs_plus_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rig(B, V, dev):
    rots = torch.eye(3, device=dev).repeat(B, V, 1, 1)
    rots[..., 0, 2] = torch.linspace(-3.0, 3.0, V, device=dev)
    rots[..., 2, 0] = 1e-3
    trs = torch.zeros(B, V, 3, device=dev)
    trs[..., 0] = torch.linspace(500.0, 8000.0, V, device=dev)
    return rots, trs


# (B, V, D, H, W, window texels, depths): a few per-pixel hypotheses at
# the launches' budget (K1's direct kernel); an expanded sweep of several
# chunks through windows of six texels, so that most taps are read from
# and added to device memory; a sweep of several chunks at per-pixel
# depths in no order, whose taps may leave K1's box of each ray's first
# and last hypothesis; the full stage-1 DTU width on the expanded sweep
WARP_CASES = {"small": (2, 3, 5, 20, 36, None, "per_pixel"),
              "overflow": (2, 3, 40, 20, 36, 6, "sweep"),
              "unsorted": (2, 3, 40, 20, 36, None, "per_pixel"),
              "dtu_stage1": (1, 4, 48, 108, 144, None, "sweep")}
# atol of the kernels against the plain versions: 1e-4 at the small maps,
# 1e-3 at 144 px wide maps, where a coordinate's rounding differs by more
# between the plain einsum and the kernels' FMAs (chip_smoke.py's ATOL)
WARP_ATOL = {"small": 1e-4, "overflow": 1e-4, "unsorted": 1e-4,
             "dtu_stage1": 1e-3}


def _warp_case(gpu, monkeypatch, case, C, dtype, seed):
    B, V, D, H, W, budget, depths = WARP_CASES[case]
    if budget is not None:
        monkeypatch.setattr(cuda_warp, "K1_WINDOW_TEXELS", budget)
        monkeypatch.setattr(cuda_warp, "K3_WINDOW_TEXELS", budget)
    g = torch.Generator(device=gpu).manual_seed(seed)
    feats = torch.randn((B, V + 1, H, W, C), generator=g, device=gpu)
    feats = feats.to(dtype)
    rots, trs = _rig(B, V, gpu)
    if depths == "sweep":
        # read through its strides, as the model hands the stage-1 sweep
        depth = torch.linspace(400.0, 900.0, D, device=gpu)[
            None, :, None, None].expand(B, D, H, W)
    else:
        depth = 400.0 + 500.0 * torch.rand((B, D, H, W), generator=g,
                                           device=gpu)
    return g, feats[:, 0], feats[:, 1:], rots, trs, depth


def _check_window_stats(case, stats, windows=True):
    """Texels (adds) served from the windows and from device memory: a
    budget of six texels cannot hold a chunk's footprint; without windows
    (K1's small texels) every texel comes from device memory."""
    window, device = int(stats[0]), int(stats[1])
    assert window + device > 0
    if not windows:
        assert window == 0
    elif case == "overflow":
        assert device > window > 0


@pytest.mark.parametrize("case", sorted(WARP_CASES))
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_matches_plain(gpu, monkeypatch, case, C, dtype):
    _, ref, src, rots, trs, depth = _warp_case(gpu, monkeypatch, case, C,
                                               dtype, 0)
    n = profiling.counter("k1.launches")
    got = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
    assert profiling.counter("k1.launches") == n + 1
    want = cuda_warp._views_torch(ref.float(), src.float(), rots, trs, depth)
    stats = torch.zeros(2, dtype=torch.int64, device=gpu)
    again = cuda_warp._views_cuda(ref, src, rots, trs, depth, stats)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = WARP_ATOL[case] \
        + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0) * want.abs()
    assert ((got.float() - want).abs() <= tol).all()
    assert torch.equal(got, again)
    windows = cuda_warp.window_plan("fwd", C, dtype, depth.shape[1])[1] > 0
    _check_window_stats(case, stats, windows)


@pytest.mark.parametrize("case", ["small", "overflow", "dtu_stage1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernels_on_row_blocks(gpu, monkeypatch, case, dtype):
    """K1 and K3 on two unequal blocks of reference rows against the whole
    source maps (the spatial layout), each with its row offset: K1
    against the plain version with the same offset and bit for bit
    against the whole image's rows, K3's d_ref and d_src against the
    plain backward with the offset."""
    g_, ref, src, rots, trs, depth = _warp_case(gpu, monkeypatch, case, 32,
                                                dtype, 4)
    H = ref.shape[1]
    whole = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
    cut = 4 * (H // 12)
    for y0, y1 in ((0, cut), (cut, H)):
        rb, db = ref[:, y0:y1], depth[:, :, y0:y1]
        got = cuda_warp.warp_correlate_views(rb, src, rots, trs, db, y0)
        want = cuda_warp._views_torch(rb.float(), src.float(), rots, trs, db,
                                      y0)
        tol = WARP_ATOL[case] \
            + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0) * want.abs()
        assert ((got.float() - want).abs() <= tol).all()
        assert torch.equal(got, whole[:, :, :, y0:y1])
        g = torch.randn(got.shape, generator=g_, device=gpu).to(dtype)
        d_ref, d_src = cuda_warp._views_bwd_cuda(rb, src, rots, trs, db, g,
                                                 y0=y0)
        # fresh leaves: fp32 .float() returns the tensor itself, whose
        # gradient would gather both blocks'
        r = rb.detach().float().clone().requires_grad_()
        s_ = src.detach().float().clone().requires_grad_()
        cuda_warp._views_torch(r, s_, rots, trs, db, y0).backward(g.float())
        for k, w in ((d_ref, r.grad), (d_src, s_.grad)):
            assert k.shape == w.shape
            atol = WARP_ATOL[case] * max(1.0, float(w.abs().max()))
            assert ((k.float() - w).abs() <= atol + (
                2.0 ** -8 if dtype == torch.bfloat16 else 0.0) * w.abs()).all()


def _bwd_plain(ref, src, rots, trs, depth, g):
    """Autograd of the plain version, in fp32 on the same values."""
    r = ref.float().requires_grad_()
    s = src.float().requires_grad_()
    cuda_warp._views_torch(r, s, rots, trs, depth).backward(g.float())
    return r.grad, s.grad


@pytest.mark.parametrize("case", sorted(WARP_CASES))
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_bwd_kernel_matches_plain(gpu, monkeypatch, case, C, dtype):
    g_, ref, src, rots, trs, depth = _warp_case(gpu, monkeypatch, case, C,
                                                dtype, 2)
    ref, src = ref.clone().requires_grad_(), src.clone().requires_grad_()
    g = torch.randn((*src.shape[:2], *depth.shape[1:]), generator=g_,
                    device=gpu).to(dtype)
    n, nb = (profiling.counter("k1.launches"),
             profiling.counter("k3.launches"))
    cuda_warp.warp_correlate_views(ref, src, rots, trs, depth).backward(g)
    assert (profiling.counter("k1.launches"),
            profiling.counter("k3.launches")) == (n + 1, nb + 1)
    want = _bwd_plain(ref.detach(), src.detach(), rots, trs, depth, g)
    stats = torch.zeros(3, dtype=torch.int64, device=gpu)
    again = cuda_warp._views_bwd_cuda(ref.detach(), src.detach(), rots, trs,
                                      depth, g, stats)
    torch.cuda.synchronize()
    for got, w, rerun in zip((ref.grad, src.grad), want, again):
        assert got.dtype == dtype and got.shape == w.shape
        atol = WARP_ATOL[case] * max(1.0, float(w.abs().max()))
        tol = atol + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0) * w.abs()
        assert ((got.float() - w).abs() <= tol).all()
        # d_src's atomics add in no fixed order: the rerun holds to the
        # same tolerance, and in fp32 lies within atol of the first run (in
        # bf16 a sum at a rounding boundary may round either way)
        assert ((rerun.float() - w).abs() <= tol).all()
        if dtype == torch.float32:
            assert float((got - rerun).abs().max()) <= atol
    # d_ref: per-view partials summed in a fixed order, the same bits
    assert torch.equal(ref.grad, again[0])
    _check_window_stats(case, stats)
    assert int(stats[2]) <= int(stats[0])
    if case == "dtu_stage1":
        assert int(stats[1]) == 0 < int(stats[2])


def _gru_case(gpu, B, H, W, hd, seed):
    g = torch.Generator(device=gpu).manual_seed(seed)
    h = torch.tanh(torch.randn((B, H, W, hd), generator=g, device=gpu))
    x = torch.randn((B, H, W, hd), generator=g, device=gpu)
    gru = ConvGRU(hd, hd).to(gpu)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g, device=gpu))
    return h, x, gru


def _check_gru(got, h, x, gru):
    """K2 against ``_gru_reference`` (the TPU kernel's rounding points) on
    the same inputs: |kernel - ref| <= 1e-4 + 2^-8 |ref| [bf16], ref before
    its last rounding.  In bf16 the two round r*h to bf16 after their own
    fp32 sums, so an r*h within fp32 noise of a rounding boundary may round
    either way: the kernel must lie within that tolerance of the range of
    h' over both roundings of every such r*h
    (``rounding_bounds.gru_bounds``; the reference itself where an output
    reads none)."""
    w = [getattr(gru, k).weight for k in ("convz", "convr", "convq")]
    b = [getattr(gru, k).bias for k in ("convz", "convr", "convq")]
    want = cuda_gru._gru_reference(h, x, *w, *b, rounded=False)
    bf16 = h.dtype == torch.bfloat16
    tol = 1e-4 + (2.0 ** -8 if bf16 else 0.0) * want.abs()
    if not bf16:
        assert ((got.float() - want).abs() <= tol).all()
        return
    lo, hi, _ = rounding_bounds.gru_bounds(h, x, *w, *b)
    g = got.double()
    assert ((lo - g).clamp(min=0) + (g - hi).clamp(min=0) <= tol).all()


@pytest.mark.parametrize("hd", [16, 32, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_kernel_matches_plain(gpu, hd, dtype):
    # 19x37 is ragged against the 8x16 tile, in both directions
    h, x, gru = _gru_case(gpu, 2, 19, 37, hd, seed=1)
    h, x = h.to(dtype), x.to(dtype)
    n = profiling.counter("k2.launches")
    with torch.inference_mode():
        got = cuda_gru.gru_step(h, x, gru)
        _check_gru(got, h, x, gru)
    torch.cuda.synchronize()
    assert profiling.counter("k2.launches") == n + 1 and got.dtype == dtype


@pytest.mark.parametrize("hd", [16, 32, 48])
def test_gru_kernel_bf16_rounds_as_the_tpu_kernel(gpu, hd):
    """A bf16 step at a larger, ragged map with the checkpoint-like input
    ranges (h = tanh, x = relu) holds to the TPU kernel's rounding points:
    r*h rounded to bf16 before the q convolution."""
    h, x, gru = _gru_case(gpu, 3, 45, 70, hd, seed=hd)
    h, x = h.to(torch.bfloat16), torch.relu(x).to(torch.bfloat16)
    with torch.inference_mode():
        got = cuda_gru.gru_step(h, x, gru)
        _check_gru(got, h, x, gru)
        # r*h kept in fp32 (no rounding before q) is another function:
        # the kernel is nearer the TPU kernel's rounding than to it
        w = [getattr(gru, k).weight for k in ("convz", "convr", "convq")]
        b = [getattr(gru, k).bias for k in ("convz", "convr", "convq")]
        tpu = cuda_gru._gru_reference(h, x, *w, *b, rounded=False)
        f32 = cuda_gru._gru_torch(h.float(), x.float(),
                                  *[t.to(torch.bfloat16).float() for t in w],
                                  *b)
        assert (got.float() - tpu).abs().mean() < (got.float() - f32).abs().mean()


def test_gru_function_backward_matches_plain(gpu):
    g_ = torch.Generator(device=gpu).manual_seed(3)
    B, H, W, hd = 2, 11, 21, 32
    h = torch.tanh(torch.randn((B, H, W, hd), generator=g_, device=gpu))
    x = torch.randn((B, H, W, hd), generator=g_, device=gpu)
    g = torch.randn((B, H, W, hd), generator=g_, device=gpu)
    gru = ConvGRU(hd, hd).to(gpu)
    grads = []
    for step in (cuda_gru.gru_step, lambda a, b, p: cuda_gru._gru_torch(
            a, b, p.convz.weight, p.convr.weight, p.convq.weight,
            p.convz.bias, p.convr.bias, p.convq.bias)):
        gru.zero_grad()
        hh, xx = h.clone().requires_grad_(), x.clone().requires_grad_()
        step(hh, xx, gru).backward(g)
        grads.append([hh.grad, xx.grad] + [p.grad.clone()
                                           for p in gru.parameters()])
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-4 * max(1.0, float(b.abs().max()))


def _chain_specs(chans, gen, dev):
    """Weights at the fan-in scale of a trained layer, so activations stay
    of order 1 through the chain."""
    specs = []
    for ci, co in zip(chans[:-1], chans[1:]):
        w = torch.randn((co, ci, 3, 3), generator=gen, device=dev) \
            * (2.0 / (9 * ci)) ** 0.5
        b = 0.1 * torch.randn((co,), generator=gen, device=dev)
        specs.append((w, b))
    return specs


@pytest.mark.parametrize("chans", cuda_conv.CHAINS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_chain_kernel_matches_plain(gpu, chans, dtype):
    g = torch.Generator(device=gpu).manual_seed(4)
    B, H, W = 2, 21, 45                   # ragged against every tile
    x = torch.randn((B, H, W, chans[0]), generator=g, device=gpu).to(dtype)
    specs = _chain_specs(chans, g, gpu)
    n = profiling.counter("k4.launches")
    got = cuda_conv.conv_bn_relu_chain(x, specs)
    assert profiling.counter("k4.launches") == n + 1
    want = cuda_conv._chain_torch(x, specs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    # fp32: the same fp32 sums in another order (the JAX test's 5e-5, at
    # the scale of the values); bf16: each layer's output is rounded to
    # bf16 (2^-8 relative), and a rounding that differs in one layer moves
    # the next by as much
    rel = 5e-5 + ((2.0 ** -8) * (len(chans) - 1)
                  if dtype == torch.bfloat16 else 0.0)
    tol = rel * want.float().abs().clamp(min=1.0)
    assert ((got.float() - want.float()).abs() <= tol).all()


def test_conv_chain_refuses_grad_and_mixed_devices(gpu):
    g = torch.Generator(device=gpu).manual_seed(5)
    x = torch.randn((1, 8, 8, 3), generator=g, device=gpu)
    specs = _chain_specs((3, 8, 8), g, gpu)
    with pytest.raises(ValueError, match="inference only"):
        cuda_conv.conv_bn_relu_chain(x.requires_grad_(), specs)
    x = x.detach()
    with pytest.raises(ValueError, match="weights on"):
        cuda_conv.conv_bn_relu_chain(
            x, [(w.cpu(), b.cpu()) for w, b in specs])
    with pytest.raises(ValueError, match="weights on"):
        cuda_conv.conv_bn_relu_chain(x.cpu(), specs)
    with pytest.raises(ValueError, match="not one the kernel"):
        cuda_conv.conv_bn_relu_chain(x, _chain_specs((3, 12, 12), g, gpu))


def test_feature_net_takes_the_chain_at_inference_only(gpu):
    """On the card an eval forward with grad off launches K4 once a level;
    grad on or train mode runs the blocks; both agree in eval."""
    net = FeatureNet((8, 16, 32, 64), (32, 16, 8)).to(gpu).eval()
    x = torch.rand((2, 32, 48, 3), device=gpu)
    n = profiling.counter("k4.launches")
    with torch.inference_mode():
        fused = net(x)
    assert profiling.counter("k4.launches") == n + 4
    unfused = net(x)
    net.train()
    with torch.no_grad():
        net(x)
    assert profiling.counter("k4.launches") == n + 4
    for k in fused:
        assert (fused[k] - unfused[k].detach()).abs().max() <= 2e-4


def test_frozen_weights_are_packed_once_and_give_the_same_maps(gpu):
    """After ``freeze_kernel_weights`` the FPN's stem chains and the GRU
    reuse one packing per dtype; their outputs equal a model that packs at
    every call."""
    g = torch.Generator(device=gpu).manual_seed(6)
    net = FeatureNet((8, 16, 32, 64), (32, 16, 8)).to(gpu).eval()
    h, x, gru = _gru_case(gpu, 2, 19, 37, 32, seed=6)
    img = torch.rand((2, 32, 48, 3), generator=g, device=gpu)
    with torch.inference_mode():
        want = net(img), gru(h, x)
        freeze_kernel_weights(net)
        freeze_kernel_weights(gru)
        for _ in range(2):
            got = net(img), gru(h, x)
    assert len(net.frozen) == 4 and list(gru.frozen) == [torch.float32]
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k])
    assert torch.equal(got[1], want[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(gpu):
    ref = torch.zeros((1, 8, 16, 12), device=gpu)          # C=12
    src = torch.zeros((1, 1, 8, 16, 12), device=gpu)
    rots, trs = _rig(1, 1, gpu)
    with pytest.raises(ValueError):
        cuda_warp.warp_correlate_views(ref, src, rots, trs,
                                       torch.ones((1, 2, 8, 16), device=gpu))
    h = torch.zeros((1, 8, 16, 24), device=gpu)            # hd=24
    with pytest.raises(ValueError):
        cuda_gru.gru_step(h, h, ConvGRU(24, 24).to(gpu))
    # cp.async needs 16-byte aligned maps
    h = torch.zeros(1 + 8 * 16 * 16, device=gpu)[1:].view(1, 8, 16, 16)
    with pytest.raises(ValueError, match="aligned"):
        cuda_gru.gru_step(h, h, ConvGRU(16, 16).to(gpu))
    x = torch.zeros(1 + 8 * 16 * 8, device=gpu)[1:].view(1, 8, 16, 8)
    with pytest.raises(ValueError, match="aligned"):
        cuda_conv.conv_bn_relu_chain(x, _chain_specs((8, 8, 8), None, gpu))
    # weights packed for another dtype
    x = torch.zeros((1, 8, 16, 8), device=gpu)
    specs = _chain_specs((8, 8, 8), None, gpu)
    with pytest.raises(ValueError, match="packed for"):
        cuda_conv.conv_bn_relu_chain(
            x, specs, cuda_conv.pack(specs, torch.bfloat16))
