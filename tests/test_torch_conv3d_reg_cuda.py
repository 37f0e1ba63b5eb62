"""The fused 3-D layers of ``ops/cuda_conv3d.py`` (``csrc/conv3d_reg.cu``)
on the card: each of the 13 layer shapes of ``CostRegNet`` and
``CSPBlock`` against the plain version in fp32 and bf16 at reduced H x W
with ragged edges and on two blocks with their halos (as under a depth
or a spatial policy), two calls bitwise equal, a layer the kernel lacks
refused, the launches of a served forward of ``EffiMVS`` (25) and of a
training step (none), and an input that requires grad refused.  Marked
``cuda``: without a GPU every test skips.  On a GPU machine: ``python -m
pytest --noconftest -m cuda tests/test_torch_conv3d_reg_cuda.py``.
Imports no JAX."""

from pathlib import Path

import pytest
import torch

from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.ops import cuda_conv3d
from effi_mvs_plus_tpu_torch.utils import profiling
from test_torch_tracing import make_batch

pytestmark = pytest.mark.cuda

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "model_dtu.npz"
# (module, layer, input (D, H, W), two inputs, residual): every layer of
# the two modules, H not a multiple of any tile's rows and W odd
SHAPES = {
    "reg.conv0": ("reg", "conv0", (12, 20, 37), False, False),
    "reg.conv1": ("reg", "conv1", (12, 20, 37), False, False),
    "reg.conv2": ("reg", "conv2", (12, 20, 37), False, False),
    "reg.conv3": ("reg", "conv3", (6, 10, 19), False, False),
    "reg.conv4": ("reg", "conv4", (6, 10, 19), False, False),
    "reg.conv5": ("reg", "conv5", (3, 5, 11), False, False),
    "reg.conv6": ("reg", "conv6", (3, 5, 11), False, True),
    "reg.conv7": ("reg", "conv7", (6, 10, 19), False, True),
    "reg.prob": ("reg", "prob", (12, 20, 37), False, False),
    "csp.conv0": ("csp", "conv0", (8, 20, 37), False, False),
    "csp.conv_cost": ("csp", "conv_cost", (8, 10, 19), False, False),
    "csp.conv1": ("csp", "conv1", (8, 10, 19), True, False),
    "csp.conv2": ("csp", "conv2", (8, 10, 19), False, False),
}
CONVS_3D = 25       # 3-D layers a forward: 9 + 4 in each of 4 CSP blocks


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _module(kind, dev):
    """A CostRegNet or CSPBlock with its BN statistics moved off their
    initial values, seeded."""
    torch.manual_seed(3)
    m = blocks.CostRegNet() if kind == "reg" else blocks.CSPBlock()
    with torch.no_grad():
        for mod in m.modules():
            if hasattr(mod, "running_var"):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.5, 0.5)
    return m.to(dev).eval().requires_grad_(False)


def _operands(name, dtype, dev):
    kind, attr, (D, H, W), two, res = SHAPES[name]
    block = getattr(_module(kind, dev), attr)
    layer = cuda_conv3d.layer(block)
    g = torch.Generator(device=dev).manual_seed(11)
    ci = layer.channels[0] // (2 if two else 1)
    x = torch.randn((2, D, H, W, ci), generator=g, device=dev).to(dtype)
    x2 = torch.randn((2, D, H, W, ci), generator=g, device=dev).to(dtype) \
        if two else None
    r = torch.randn(cuda_conv3d.out_shape(x, layer), generator=g,
                    device=dev).to(dtype) if res else None
    return x, layer, x2, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_the_plain_version(gpu, name, dtype):
    """fp32: within 1e-5 of the largest output (another order of the
    same fp32 sums); bf16: within one bf16 step of each output, where a
    sum within fp32 noise of a rounding boundary may round either way."""
    x, layer, x2, res = _operands(name, dtype, gpu)
    n0 = profiling.counter("conv3d_reg.launches")
    got = cuda_conv3d.conv3d_reg(x, layer, x2, res).double()
    assert profiling.counter("conv3d_reg.launches") - n0 == 1
    want = cuda_conv3d._reg_torch(x, layer, x2, res).double()
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0
    if dtype == torch.float32:
        tol = 1e-5 * scale + 1e-6 * want.abs()
    else:
        tol = 2.0 ** -7 * want.abs() + 1e-5 * scale
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"max err {float(err.max()):.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["reg.conv1", "reg.conv6", "csp.conv1",
                                  "csp.conv2"])
def test_two_calls_are_bitwise_equal(gpu, name, dtype):
    x, layer, x2, res = _operands(name, dtype, gpu)
    a = cuda_conv3d.conv3d_reg(x, layer, x2, res)
    b = cuda_conv3d.conv3d_reg(x, layer, x2, res)
    assert torch.equal(a, b)


@pytest.mark.parametrize("axis", [1, 2], ids=["depth", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_a_layer_on_blocks_with_halos_is_the_whole_volumes(gpu, name, dtype,
                                                           axis):
    """The kernel on two blocks of the volume along D or H, each with the
    halo ``parallel.on_block`` asks for (as under a depth or a spatial
    policy), joined, against the kernel on the whole volume, at
    ``test_kernel_matches_the_plain_version``'s tolerance."""
    from test_torch_conv3d_reg import on_blocks
    x, layer, x2, res = _operands(name, dtype, gpu)
    want = cuda_conv3d.conv3d_reg(x, layer, x2, res).double()
    got = on_blocks(layer, x, x2, res, axis,
                    max(2, x.shape[axis] // 4 * 2)).double()
    assert got.shape == want.shape
    scale = float(want.abs().max())
    if dtype == torch.float32:
        tol = 1e-5 * scale + 1e-6 * want.abs()
    else:
        tol = 2.0 ** -7 * want.abs() + 1e-5 * scale
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"max err {float(err.max()):.3e}"


def test_a_layer_the_kernel_lacks_raises(gpu):
    """A layer shape outside the kernel's built list (4 -> 8 channels) is
    refused by the C dispatch, and the wrapper raises."""
    from effi_mvs_plus_tpu_torch import nn
    blk = nn.ConvBlock(3, 4, 8).to(gpu).eval().requires_grad_(False)
    x = torch.zeros((1, 4, 8, 8, 4), device=gpu)
    with pytest.raises(RuntimeError, match="conv3d_reg"):
        cuda_conv3d.conv3d_reg(x, cuda_conv3d.layer(blk))


def test_input_that_requires_grad_is_refused(gpu):
    x, layer, _, _ = _operands("reg.conv0", torch.float32, gpu)
    with pytest.raises(ValueError, match="inference only"):
        cuda_conv3d.conv3d_reg(x.requires_grad_(True), layer)


@pytest.fixture(scope="module")
def served():
    """A served EffiMVS on the card (the shipped DTU weights, frozen as
    the engine freezes them) and a small batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import (EffiMVSConfig, build_model,
                                                freeze_kernel_weights)
    from effi_mvs_plus_tpu_torch.train.trainer import batch_to_device
    dev = torch.device("cuda")
    sd = load_state_dict(str(CKPT))
    model = build_model(sd, EffiMVSConfig(), dev)
    batch = batch_to_device(make_batch(2, with_depth=True, H=128, W=160,
                                       V=3), dev)
    return model, freeze_kernel_weights, batch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_a_served_forward_launches_25_and_a_training_step_none(served,
                                                                dtype):
    """25 fused launches a served forward, and the same maps as the
    layer-by-layer path to within the bf16 forward's own noise; a
    training step (grad on) runs the 3-D layers one by one: no launch,
    and 25 weight gradients through the split-K GEMM."""
    import copy
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss
    model, freeze, batch = served
    model = copy.deepcopy(model)
    model.cfg = EffiMVSConfig(compute_dtype=dtype)
    model.eval()
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    with torch.inference_mode():
        n0 = profiling.counter("conv3d_reg.launches")
        fused = model(*args)["depth"][-1]
        n1 = profiling.counter("conv3d_reg.launches")
        saved = blocks.reg_applies
        blocks.reg_applies = lambda x, training: False
        try:
            plain = model(*args)["depth"][-1]
        finally:
            blocks.reg_applies = saved
    assert n1 - n0 == CONVS_3D
    assert profiling.counter("conv3d_reg.launches") == n1
    gap = float((fused - plain).abs().median())
    assert gap < (1e-3 if dtype == torch.float32
                  else 0.05 * float(plain.median()))

    frozen = freeze(copy.deepcopy(model))
    with torch.inference_mode():
        n0 = profiling.counter("conv3d_reg.launches")
        again = frozen(*args)["depth"][-1]
        frozen(*args)
    assert profiling.counter("conv3d_reg.launches") - n0 == 2 * CONVS_3D
    assert torch.equal(again, fused)

    if dtype == torch.float32:
        model.train()
        n0 = profiling.counter("conv3d_reg.launches")
        w0 = profiling.counter("conv_wgrad.calls")
        out = model(*args)
        loss, _ = mvs_loss(out["depth"], batch["depth"], batch["mask"])
        loss.backward()
        assert profiling.counter("conv3d_reg.launches") == n0
        assert profiling.counter("conv_wgrad.calls") - w0 == CONVS_3D
