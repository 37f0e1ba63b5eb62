"""The port's tracer (``utils/profiling.py``) on the card: the counters
and device spans of a served batch and of a training step, with the
shipped DTU weights at the published DTU configuration and a small
image.  Marked ``cuda``: without a GPU every test skips.  On a GPU
machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_tracing_cuda.py``.  Imports no JAX."""

from pathlib import Path

import pytest
import torch

from effi_mvs_plus_tpu_torch.utils.profiling import tracing
from test_torch_tracing import make_batch

pytestmark = pytest.mark.cuda

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "model_dtu.npz"
H, W, V = 256, 320, 5           # a small image, the published 5 views
STAGES = ("model.stage1", "model.stage2", "model.stage3")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def test_a_served_batch_counts_its_launches(gpu, tmp_path):
    """The DTU evaluation's model (bf16, frozen weights) on a batch of 2:
    no operand packed at call time; K1 once a stage, K2 once a GRU
    iteration, K4 once a stride-1 FPN run; every span timed on the
    device; ``save_scene_depths``' device time from its batches' spans."""
    from effi_mvs_plus_tpu_torch.infer import InferenceEngine
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    B = 2
    engine = InferenceEngine(load_state_dict(str(CKPT)),
                             EffiMVSConfig(compute_dtype=torch.bfloat16),
                             device=gpu)
    batch = make_batch(B, H=H, W=W, V=V)
    engine.infer_batch(batch)                      # packs the frozen weights
    with tracing() as rec:
        engine.infer_batch(batch)
    upload = batch["imgs"].nbytes + batch["depth_values"].nbytes + sum(
        batch["proj_matrices"][f"stage{s}"].nbytes for s in (1, 2, 3))
    assert rec.counters.get("conv_pack.packs", 0) == 0
    assert (rec.counters["k1.launches"], rec.counters["k2.launches"],
            rec.counters["k4.launches"]) == (3, 9, 8)
    assert rec.counters["engine.upload_bytes"] == upload
    parts = [rec.device_ms(n) for n in ("model.features",) + STAGES]
    assert all(p > 0 for p in parts), parts
    assert sum(parts) <= rec.device_ms("engine.forward") * 1.01
    assert rec.device_ms("engine.forward") <= \
        rec.device_ms("engine.batch") * 1.01
    names = [f"scan1/{{}}/{b:08d}{{}}" for b in range(B)]
    stats = engine.save_scene_depths([dict(batch, filename=names)],
                                     str(tmp_path), verbose=False)
    assert stats["maps"] == B and stats["device_s"] > 0


def test_a_training_step_counts_its_launches(gpu):
    """The DTU training step (fp32) on a batch of 1: K2's operands packed
    at each of its 9 launches (grad on), K1 and K3 once a stage, no K4,
    and the step's forward, backward and optimizer timed on the
    device."""
    from effi_mvs_plus_tpu_torch.io import load_state_dict
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig, build_model
    from effi_mvs_plus_tpu_torch.train.optim import make_optimizer
    from effi_mvs_plus_tpu_torch.train.trainer import make_train_step
    model = build_model(load_state_dict(str(CKPT)), EffiMVSConfig(), gpu)
    opt, sched, _ = make_optimizer(model, 1e-3, 100, 1e-3)
    step = make_train_step(model, opt, sched, device=gpu)
    batch = make_batch(1, with_depth=True, H=H, W=W, V=V)
    step(batch)
    with tracing() as rec:
        float(step(batch)["loss"])
    assert rec.counters["conv_pack.packs"] == rec.counters["k2.launches"] \
        == 9
    assert rec.counters["k1.launches"] == rec.counters["k3.launches"] \
        == len(STAGES)
    assert "k4.launches" not in rec.counters
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert rec.device_ms(name) > 0, name
    assert rec.units() == 1
