"""Dataset registry: the names a profile's or a CLI's ``--dataset``
takes, and ``register_dataset`` for a reader of one's own."""

from __future__ import annotations

from effi_mvs_plus_tpu_torch.data import datasets as _ds

_REGISTRY = {
    "dtu_yao": _ds.DTUTrainDataset,
    "dtu": _ds.DTUTrainDataset,
    "general_eval": _ds.GeneralEvalDataset,
    "blend": _ds.BlendedMVSDataset,
    "blendedmvs": _ds.BlendedMVSDataset,
    "tank": _ds.TanksDataset,
    "tanks": _ds.TanksDataset,
}


def find_dataset(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None


def register_dataset(name, cls):
    """Register a dataset class or factory under ``name`` (usable as
    ``--dataset`` in the CLIs)."""
    _REGISTRY[name] = cls
