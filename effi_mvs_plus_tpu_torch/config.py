"""Named run profiles and the CLI defaults they set.

The port's copy of ``effi_mvs_plus_tpu/config.py``: the reference's
shell presets become named ``PROFILES``, and ``apply_profile_defaults``
points an argparse parser's defaults at one; the fusion constants
(``DypcdParams``, ``TankParams``, ``TANK_FILTER_CONFIGS``) live here once.
``EffiMVSConfig`` is the port's own (``models/effi_mvs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from effi_mvs_plus_tpu_torch.models.effi_mvs import EffiMVSConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + preprocessing."""
    dataset: str = "dtu_yao"
    nviews: int = 5
    numdepth: int = 384
    interval_scale: float = 0.53
    max_h: int = 1184            # general_eval resize bound (test_dtu.sh)
    max_w: int = 1600
    num_workers: int = 8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop."""
    epochs: int = 16
    batch_size: int = 16         # the global batch, split over data ranks
    lr: float = 1e-3
    weight_decay: float = 1e-3
    loss_rate: float = 1.0
    summary_freq: int = 50
    save_freq: int = 1
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class DypcdParams:
    """DTU dypcd fusion constants: consistency ladder i in [s, e),
    dist < i*dist_base px, depth diff < log10(max(i,1.05))*diff_base mm;
    photometric mask at conf_thresh; high-confidence depths override the
    fused average."""
    s: int = 1
    e: int = 11
    dist_base: float = 0.5
    diff_base: float = 0.25
    conf_thresh: float = 0.5
    conf_override: float = 0.75


@dataclasses.dataclass(frozen=True)
class TankParams:
    """Per-scene Tanks & Temples filter config."""
    views: int = 11
    dh_view_num: int = 2
    dist_filter: float = 2.0
    depth_filter: float = 6000.0
    prob_threshold: float = 0.5
    relative: bool = False


# Deployed per-scene T&T configs (reference test_tank.py:600-615).
TANK_FILTER_CONFIGS = {
    **{s: TankParams() for s in
       ("Family", "Francis", "Lighthouse", "M60", "Panther", "Playground",
        "Train")},
    "Horse": TankParams(dist_filter=4, prob_threshold=0.3),
    "Auditorium": TankParams(dist_filter=1, depth_filter=500,
                             prob_threshold=0.3),
    **{s: TankParams(dist_filter=1, depth_filter=1600, prob_threshold=0.3)
       for s in ("Ballroom", "Courtroom", "Museum", "Palace", "Temple")},
}


@dataclasses.dataclass(frozen=True)
class RunProfile:
    """A named end-to-end preset."""
    name: str
    model: EffiMVSConfig
    data: DataConfig
    train: Optional[TrainConfig] = None
    fusion: Optional[DypcdParams] = None
    lists: Tuple[str, ...] = ()          # the repo's scan lists


_DTU_ARCH = EffiMVSConfig()                            # ndepths (48,8,8)
_TANK_ARCH = EffiMVSConfig(ndepths=(96, 8, 8))

PROFILES = {
    # DTU training
    "dtu_train": RunProfile(
        name="dtu_train", model=_DTU_ARCH,
        data=DataConfig(dataset="dtu_yao", nviews=5),
        train=TrainConfig(),
        lists=("lists/dtu/train.txt", "lists/dtu/test.txt")),
    # BlendedMVS fine-tuning (96-hypothesis sweep, 7 views)
    "blend_finetune": RunProfile(
        name="blend_finetune", model=_TANK_ARCH,
        data=DataConfig(dataset="blend", nviews=7),
        train=TrainConfig(epochs=10, batch_size=8, lr=4e-4),
        lists=("lists/bld/training_list.txt",
               "lists/bld/validation_list.txt")),
    # DTU evaluation + dypcd fusion
    "dtu_eval": RunProfile(
        name="dtu_eval", model=_DTU_ARCH,
        data=DataConfig(dataset="general_eval", nviews=5),
        fusion=DypcdParams(),
        lists=("lists/dtu/test.txt",)),
    # Tanks & Temples at 1920x1056, 11 views
    "tank_eval": RunProfile(
        name="tank_eval", model=_TANK_ARCH,
        data=DataConfig(dataset="tank", nviews=11, max_h=1056, max_w=1920),
        fusion=DypcdParams()),
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
    else:
        d.update(num_view=profile.data.nviews,
                 max_h=profile.data.max_h, max_w=profile.data.max_w)
    if profile.fusion is not None:
        d.update(conf=profile.fusion.conf_thresh,
                 dist_base=profile.fusion.dist_base,
                 diff_base=profile.fusion.diff_base)
    known = {a.dest for a in parser._actions}
    parser.set_defaults(**{k: v for k, v in d.items() if k in known})
