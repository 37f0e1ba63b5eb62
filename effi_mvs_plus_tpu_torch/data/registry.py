"""Dataset registry: the names the train CLI's ``--dataset`` takes.

The port has the DTU training reader so far; the eval, BlendedMVS and
Tanks & Temples readers of the JAX package are still to be ported.
"""

from __future__ import annotations

from effi_mvs_plus_tpu_torch.data import datasets as _ds

_REGISTRY = {
    "dtu_yao": _ds.DTUTrainDataset,
    "dtu": _ds.DTUTrainDataset,
}


def find_dataset(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"dataset {name!r} is not in the port (yet); "
                         f"available: {sorted(_REGISTRY)}") from None

