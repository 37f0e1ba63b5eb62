"""Named run profiles and the CLI defaults they set.

The port's copy of the training part of ``effi_mvs_plus_tpu/config.py``:
the reference's shell presets become named ``PROFILES``, and
``apply_profile_defaults`` points an argparse parser's defaults at one.
``EffiMVSConfig`` is the port's own (``models/effi_mvs.py``).  The
BlendedMVS finetune profile comes with the slice that ports finetuning,
the fusion and Tanks & Temples parameters with those that port fusion and
evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from effi_mvs_plus_tpu_torch.models.effi_mvs import EffiMVSConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + preprocessing."""
    dataset: str = "dtu_yao"
    nviews: int = 5
    numdepth: int = 384
    interval_scale: float = 0.53
    num_workers: int = 8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop."""
    epochs: int = 16
    batch_size: int = 16
    lr: float = 1e-3
    weight_decay: float = 1e-3
    loss_rate: float = 1.0
    summary_freq: int = 50
    save_freq: int = 1
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class RunProfile:
    """A named end-to-end preset."""
    name: str
    model: EffiMVSConfig
    data: DataConfig
    train: Optional[TrainConfig] = None


_DTU_ARCH = EffiMVSConfig()                            # ndepths (48,8,8)

PROFILES = {
    # DTU training
    "dtu_train": RunProfile(
        name="dtu_train", model=_DTU_ARCH,
        data=DataConfig(dataset="dtu_yao", nviews=5),
        train=TrainConfig()),
}


def get_profile(name: str) -> RunProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise SystemExit(
            f"unknown profile {name!r}; available: {sorted(PROFILES)}")


def apply_profile_defaults(parser, profile: RunProfile):
    """Point an argparse parser's defaults at a profile (CLI flags still
    override)."""
    d = {
        "ndepths": ",".join(str(n) for n in profile.model.ndepths),
        "GRUiters": ",".join(str(n) for n in profile.model.gru_iters),
        "CostNum": profile.model.CostNum,
        "dataset": profile.data.dataset,
        "numdepth": profile.data.numdepth,
        "interval_scale": profile.data.interval_scale,
        "num_workers": profile.data.num_workers,
    }
    if profile.train is not None:
        d.update(epochs=profile.train.epochs,
                 batch_size=profile.train.batch_size,
                 lr=profile.train.lr, wd=profile.train.weight_decay,
                 lossrate=profile.train.loss_rate,
                 trainviews=profile.data.nviews,
                 testviews=profile.data.nviews,
                 summary_freq=profile.train.summary_freq,
                 save_freq=profile.train.save_freq,
                 seed=profile.train.seed)
    known = {a.dest for a in parser._actions}
    parser.set_defaults(**{k: v for k, v in d.items() if k in known})
