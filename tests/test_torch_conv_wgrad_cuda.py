"""The 3-D weight gradients of ``ops/conv_wgrad.py`` on the card: the DTU
training step at the ``dtu_train-b4`` size (640x512, 5 views, B=4, fp32
with TF32 off, the shipped DTU weights) against the same step with every
convolution through plain autograd (cuDNN's weight gradient), by
``chip_smoke.py``'s gradient criterion, and two steps from one state,
whose split-K weight gradients are bitwise equal wherever their inputs
are.  Marked ``cuda``: without a GPU every test skips.  On a GPU
machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_conv_wgrad_cuda.py``.  Imports no JAX."""

import contextlib
from pathlib import Path

import pytest
import torch

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.ops import conv_wgrad
from effi_mvs_plus_tpu_torch.utils import profiling
from test_torch_tracing import make_batch

pytestmark = pytest.mark.cuda

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "model_dtu.npz"
B, H, W, V = 4, 512, 640, 5
CONVS = 25              # 3-D convolutions and transposed ones that train


@pytest.fixture(scope="module")
def step():
    """(model, batch on the card, state) at the cell's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model
    from effi_mvs_plus_tpu_torch.train.trainer import batch_to_device
    dev = torch.device("cuda")
    model = build_model(load_state_dict(str(CKPT)), EffiMVSConfig(), dev)
    batch = batch_to_device(make_batch(B, with_depth=True, H=H, W=W, V=V),
                            dev)
    return model, batch, {k: v.clone() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def cudnn_wgrad():
    """Every convolution through plain autograd."""
    saved = conv_wgrad.applies
    conv_wgrad.applies = lambda x, w: False
    try:
        yield
    finally:
        conv_wgrad.applies = saved


def loss_and_grads(model, batch, state):
    """One step's loss and gradients from ``state``, dropout seeded;
    leaves the model at ``state``."""
    from effi_mvs_plus_tpu_torch.train.loss import mvs_loss
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    model.train()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    nn.use_generator(model, gen)
    out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    loss, _ = mvs_loss(out["depth"], batch["depth"], batch["mask"])
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def test_the_step_matches_cudnns_weight_gradients(step):
    """Loss rtol 2e-4; every leaf rel-l2 < 5e-2 with cosine > 0.999, the
    90th percentile < 1e-2 (``chip_smoke.compare_grads``); 25 weight
    gradients a step through the split-K GEMM, none on the cuDNN path."""
    import chip_smoke
    n0 = profiling.counter("conv_wgrad.calls")
    loss_k, grads_k = loss_and_grads(*step)
    n1 = profiling.counter("conv_wgrad.calls")
    with cudnn_wgrad():
        loss_p, grads_p = loss_and_grads(*step)
    assert (n1 - n0, profiling.counter("conv_wgrad.calls") - n1) == \
        (CONVS, 0)
    assert set(grads_k) == set(grads_p)
    chip_smoke.compare_grads(loss_k, grads_k, loss_p, grads_p)


@contextlib.contextmanager
def recorded(calls):
    """Each ``weight_grad`` call's inputs, arguments and result, kept."""
    orig = conv_wgrad.weight_grad

    def record(x, g, *args, **kw):
        out = orig(x, g, *args, **kw)
        calls.append((x.clone(), g.clone(), args, kw, out.clone()))
        return out
    conv_wgrad.weight_grad = record
    try:
        yield orig
    finally:
        conv_wgrad.weight_grad = orig


def test_two_steps_are_bitwise_equal(step):
    """The same step twice from one state, cuDNN held to its
    deterministic algorithms: every split-K weight gradient whose inputs
    are bitwise equal in both steps is bitwise equal, and each is
    bitwise what a third call on its step's inputs gives.  (The whole
    step is not bitwise: K3 adds into shared memory in no fixed order,
    so the leaves its gradient reaches differ in their last bits.)"""
    steps = []
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            calls = []
            with recorded(calls) as weight_grad:
                loss, _ = loss_and_grads(*step)
            steps.append((loss, calls))
    finally:
        torch.backends.cudnn.deterministic = False
    (loss_a, a), (loss_b, b) = steps
    assert len(a) == len(b) == CONVS
    same = 0
    for (xa, ga, args, kw, out_a), (xb, gb, _, _, out_b) in zip(a, b):
        assert torch.equal(weight_grad(xa, ga, *args, **kw), out_a)
        if torch.equal(xa, xb) and torch.equal(ga, gb):
            same += 1
            assert torch.equal(out_a, out_b)
    assert same > 0, "no weight gradient saw the same inputs twice"
