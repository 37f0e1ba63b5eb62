"""Dataset registry: the names a profile's or a CLI's ``--dataset``
takes.  The BlendedMVS reader of the JAX package is still to be ported.
"""

from __future__ import annotations

from effi_mvs_plus_tpu_torch.data import datasets as _ds

_REGISTRY = {
    "dtu_yao": _ds.DTUTrainDataset,
    "dtu": _ds.DTUTrainDataset,
    "general_eval": _ds.GeneralEvalDataset,
    "tank": _ds.TanksDataset,
}


def find_dataset(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"dataset {name!r} is not in the port (yet); "
                         f"available: {sorted(_REGISTRY)}") from None

