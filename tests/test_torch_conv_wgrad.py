"""``ops/conv_wgrad.py`` on the CPU: the split-K weight gradient and the
autograd Function against plain autograd, at every distinct convolution
shape the model trains (read from a hooked train-mode forward at a small
size): the 3-D convolutions and transposed convolutions through the
Function, the 2-D ones through ``weight_grad``; chunks and slices that
do not divide the positions; a concatenated, non-leaf weight;
repeatability; the counters; and the dispatch of ``nn``, which keeps
plain ``F`` calls alone on the CPU and for a frozen weight.  Imports no
JAX."""

import math
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.ops import conv_wgrad
from effi_mvs_plus_tpu_torch.utils import profiling

LAYERS = {"conv2d": 60, "conv3d": 13, "conv_transpose3d": 4}
SIZE = (128, 160)           # the image of the hooked forward
FNS = {"conv2d": F.conv2d, "conv3d": F.conv3d,
       "conv_transpose3d": F.conv_transpose3d}


def rel(a, b):
    return float((a - b).norm() / b.norm())


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


@pytest.fixture(scope="module")
def shapes():
    """{kind: [(input shape (N, C, *spatial), weight shape, stride,
    padding, output padding)]} of the convolutions whose weight trains
    in one train-mode forward of ``EffiMVS`` (B=1, 5 views, 128x160), in
    order of first call."""
    from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
    from effi_mvs_plus_tpu_torch.train.trainer import batch_to_device
    from test_torch_tracing import make_batch
    found = {kind: {} for kind in FNS}

    def hooked(kind):
        def conv(x, w, b=None, stride=1, padding=0, *rest):
            if w.requires_grad and torch.is_grad_enabled():
                n = x.dim() - 2
                opad = _tuple(rest[0] if rest else 0, n)
                found[kind].setdefault((tuple(x.shape), tuple(w.shape),
                                        _tuple(stride, n),
                                        _tuple(padding, n), opad), None)
            return FNS[kind](x, w, b, stride, padding, *rest)
        return conv
    torch.manual_seed(0)
    model = EffiMVS(EffiMVSConfig())
    model.train()
    batch = batch_to_device(make_batch(1, with_depth=True, H=SIZE[0],
                                       W=SIZE[1], V=5), torch.device("cpu"))
    for kind in FNS:
        setattr(F, kind, hooked(kind))
    try:
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    finally:
        for kind, fn in FNS.items():
            setattr(F, kind, fn)
    return {kind: list(keys) for kind, keys in found.items()}


def inputs(kind, key, seed=0):
    """x, w and an output gradient g, channels-last memory viewed
    channels-first as ``nn`` hands them to torch."""
    xs, ws, stride, padding, opad = key
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(xs[:1] + xs[2:] + xs[1:2], generator=gen).movedim(-1, 1)
    w = torch.randn(ws, generator=gen)
    args = (stride, padding) + ((opad,) if kind == "conv_transpose3d"
                                else ())
    y = FNS[kind](x, w, None, *args)
    g = torch.randn(y.movedim(1, -1).shape, generator=gen).movedim(-1, 1)
    return x, w, g, args


def plain(kind, x, w, args, g):
    """Input and weight gradients of plain autograd."""
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    FNS[kind](x, w, None, *args).backward(g)
    return x.grad, w.grad


def split_k(kind, x, w, g, stride, padding, **kw):
    a, b = x.movedim(1, -1), g.movedim(1, -1)
    if kind == "conv_transpose3d":
        a, b = b, a
    return conv_wgrad.weight_grad(a, b, w.shape[2:], stride, padding, **kw)


def few_runs(kind, x, w, g, stride):
    """A budget of about 3 runs of the first output axis a chunk."""
    xl, gl = (g, x) if kind == "conv_transpose3d" else (x, g)
    c, o = xl.shape[1], gl.shape[1]
    per = 4 * (c * w[0, 0].numel() + o
               + c * math.prod(_tuple(stride, w.dim() - 2)))
    return per * 3 * math.prod(gl.shape[3:])


def test_the_model_trains_the_counted_layers(shapes):
    assert {k: len(v) for k, v in shapes.items()} == LAYERS
    assert {k[1][2] for k in shapes["conv2d"]} == {1, 3, 5, 7}


@pytest.mark.parametrize("kind,i", [(k, i) for k, n in LAYERS.items()
                                    if k != "conv2d" for i in range(n)])
def test_the_function_matches_autograd_at_each_3d_layer(shapes, kind, i):
    """Output bitwise, input and weight gradients at rel-l2 1e-5 on
    channels-last tensors; the split-K also in chunks of a few runs of
    the first axis."""
    x, w, g, args = inputs(kind, shapes[kind][i], i)
    want_x, want_w = plain(kind, x, w, args, g)
    xa, wa = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = getattr(conv_wgrad, kind)(xa, wa, None, *args)
    assert torch.equal(y, FNS[kind](x, w, None, *args))
    y.backward(g)
    assert rel(wa.grad, want_w) < 1e-5
    assert rel(xa.grad, want_x) < 1e-5
    got = split_k(kind, x, w, g, *args[:2],
                  budget=few_runs(kind, x, w, g, args[0]))
    assert rel(got, want_w) < 1e-5


@pytest.mark.parametrize("i", range(LAYERS["conv2d"]))
def test_the_split_k_matches_autograd_at_each_2d_layer(shapes, i):
    """The same GEMM at the 2-D layers' geometries (1x1 to 7x7, stride 2,
    padding 3), the plan's chunks and chunks of a few rows."""
    x, w, g, args = inputs("conv2d", shapes["conv2d"][i], i)
    _, want = plain("conv2d", x, w, args, g)
    assert rel(split_k("conv2d", x, w, g, *args), want) < 1e-5
    got = split_k("conv2d", x, w, g, *args,
                  budget=few_runs("conv2d", x, w, g, args[0]))
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("kind,key,budget,plan", [
    # 16 rows of 23, then 7: 592 positions in 2 slices, 259 % 2 left over
    ("conv2d", ((3, 3, 23, 37), (8, 3, 3, 3), 1, 1, 0),
     4 * (27 + 8 + 3) * 600, (1, 16, 2)),
    # 3 whole images: 2553 positions in 9 slices, 2553 % 9
    ("conv2d", ((3, 3, 23, 37), (8, 3, 3, 3), 1, 1, 0), 1 << 30,
     (3, 23, 9)),
    # 5 planes of 7 (the last 2) of 11x13 at stride (1, 2, 2): 715 in 2
    # slices, 715 % 2 and 286 % 2
    ("conv3d", ((2, 4, 7, 21, 25), (8, 4, 3, 3, 3), (1, 2, 2), 1, 0),
     4 * (108 + 8 + 16) * 5 * 143, (1, 5, 2)),
    # the transposed layer: its input's 5 planes of 7 at 11x13 a chunk,
    # 715 positions in 2 slices, 715 % 2
    ("conv_transpose3d", ((2, 8, 7, 11, 13), (8, 1, 3, 3, 3), (1, 2, 2), 1,
                          (0, 1, 1)), 4 * (27 + 8 + 4) * 5 * 143,
     (1, 5, 2)),
])
def test_chunks_and_slices_that_do_not_divide(kind, key, budget, plan):
    """Chunks that leave a shorter last chunk, slices that leave a
    remainder."""
    x, w, g, args = inputs(kind, key)
    _, want = plain(kind, x, w, args, g)
    t = kind == "conv_transpose3d"
    xl, gl = (g, x) if t else (x, g)
    assert conv_wgrad.plan(xl.shape[0], list(gl.shape[2:]), xl.shape[1],
                           gl.shape[1], w.shape[2:],
                           _tuple(args[0], w.dim() - 2), budget) == plan
    got = split_k(kind, x, w, g, *args[:2], budget=budget)
    assert rel(got, want) < 1e-5


def test_a_concatenated_non_leaf_weight():
    """A weight made by concatenating two (as the ConvGRU's z and r
    gates are): each part's gradient through the Function as plain
    autograd's."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 10, 12, 5, generator=gen).movedim(-1, 1)
    parts = [torch.randn(4, 5, 3, 3, 3, generator=gen) for _ in range(2)]
    g = torch.randn(2, 6, 10, 12, 8, generator=gen).movedim(-1, 1)

    def grads(conv):
        leaves = [p.detach().requires_grad_() for p in parts]
        conv(x, torch.cat(leaves), None, 1, 1).backward(g)
        return [p.grad for p in leaves]
    for a, b in zip(grads(conv_wgrad.conv3d), grads(F.conv3d)):
        assert rel(a, b) < 1e-5


def test_two_calls_are_bitwise_equal():
    x, w, g, args = inputs("conv3d", ((2, 8, 8, 20, 24), (16, 8, 3, 3, 3),
                                      1, 1, 0))
    a = split_k("conv3d", x, w, g, *args, budget=1 << 16)
    b = split_k("conv3d", x, w, g, *args, budget=1 << 16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind,key,patch", [
    ("conv3d", ((2, 6, 4, 10, 12), (8, 6, 3, 3, 3), 1, 1, 0),
     2 * 4 * 10 * 12 * 6 * 27 * 4),
    ("conv3d", ((2, 6, 4, 10, 12), (8, 6, 3, 3, 3), (1, 2, 2), 1, 0),
     2 * 4 * 5 * 6 * 6 * 27 * 4),
    # the patch matrix of the output gradient, at the input's positions
    ("conv_transpose3d", ((2, 6, 4, 5, 6), (6, 8, 3, 3, 3), (1, 2, 2), 1,
                          (0, 1, 1)), 2 * 4 * 5 * 6 * 8 * 27 * 4),
    ("conv3d", ((2, 6, 4, 10, 12), (8, 6, 1, 1, 1), 1, 0, 0), 0),
])
def test_the_counters(kind, key, patch):
    """One call and the patch matrices' bytes a weight gradient; a 1x1x1
    convolution of a dense input writes none."""
    x, w, g, args = inputs(kind, key)
    n0 = profiling.counter("conv_wgrad.calls")
    b0 = profiling.counter("conv_wgrad.patch_bytes")
    getattr(conv_wgrad, kind)(x, w.requires_grad_(), None,
                              *args).backward(g)
    assert profiling.counter("conv_wgrad.calls") - n0 == 1
    assert profiling.counter("conv_wgrad.patch_bytes") - b0 == patch


def test_the_input_gradient_is_skipped_where_the_input_is_data():
    x, w, g, args = inputs("conv3d", ((1, 3, 4, 9, 11), (4, 3, 3, 3, 3), 1,
                                      1, 0))
    w.requires_grad_()
    conv_wgrad.conv3d(x, w, None, *args).backward(g)
    assert x.grad is None and w.grad is not None


def test_the_dispatch():
    """A CUDA input whose weight trains, grad on: the Function; a frozen
    weight, grad off or the CPU: plain ``F``."""
    cuda, cpu = SimpleNamespace(is_cuda=True), SimpleNamespace(is_cuda=False)
    trains, frozen = SimpleNamespace(requires_grad=True), \
        SimpleNamespace(requires_grad=False)
    assert conv_wgrad.applies(cuda, trains)
    assert not conv_wgrad.applies(cuda, frozen)
    assert not conv_wgrad.applies(cpu, trains)
    with torch.no_grad():
        assert not conv_wgrad.applies(cuda, trains)


def test_nn_calls_plain_f_alone_on_the_cpu(monkeypatch):
    """``nn.conv2d``, ``conv3d`` and ``conv_transpose3d`` on the CPU, with
    a weight that trains and a frozen one: the ``F`` call alone."""
    calls = []

    def counted(kind):
        def fn(*a, **k):
            calls.append(kind)
            return FNS[kind](*a, **k)
        return fn

    def refused(*a):
        raise AssertionError("the split-K Function ran")
    for kind in FNS:
        monkeypatch.setattr(F, kind, counted(kind))
    monkeypatch.setattr(conv_wgrad._Conv, "apply", refused)
    x2, x3 = torch.randn(1, 8, 9, 4), torch.randn(1, 4, 8, 9, 4)
    for trains in (True, False):
        w2 = torch.randn(5, 4, 3, 3, requires_grad=trains)
        w3 = torch.randn(5, 4, 3, 3, 3, requires_grad=trains)
        wt = torch.randn(4, 5, 3, 3, 3, requires_grad=trains)
        out = (nn.conv2d(x2, w2, None, 1, 1).sum()
               + nn.conv3d(x3, w3, None, 1, 1).sum()
               + nn.conv_transpose3d(x3, wt, None, 2, 1, 1).sum())
        if trains:
            out.backward()
            assert w3.grad is not None and wt.grad is not None
    assert calls == ["conv2d", "conv3d", "conv_transpose3d"] * 2
