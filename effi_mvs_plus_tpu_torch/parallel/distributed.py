"""Multi-process runtime: one process per GPU.

The port of ``effi_mvs_plus_tpu/parallel/distributed.py``.  The JAX package
drives every device of a host from one process and lets XLA insert the
collectives; the port runs one process per GPU (``torchrun`` or any
launcher that sets the environment below) and writes its collectives out
with ``torch.distributed``: NCCL between GPUs, gloo on the CPU.

* ``initialize()``   — the rendezvous, from torchrun's ``RANK``,
                       ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` or
                       the JAX names ``PROCESS_ID``, ``NUM_PROCESSES``,
                       ``COORDINATOR_ADDRESS``; a no-op for one process
* ``rank_device()``  — the device a rank drives (``cuda:<local rank>``)
* ``global_mesh()``  — the (data, model) grid over every process
* ``mean_metrics()`` — the mean of scalar metrics over the processes,
                       symmetric: every rank gets it
* ``partition()``    — a static round-robin split of work items
* ``hosts()``        — the machines the processes run on
* ``is_main()``, ``barrier()``
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _env(*names, default=None):
    for n in names:
        if os.environ.get(n):
            return os.environ[n]
    return default


def initialize(backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join the process group.  Returns False, and does nothing, when the
    arguments and the environment describe a single process.

    The backend follows ``device`` (``cuda`` unless told otherwise): NCCL
    on a CUDA device, gloo on the CPU; ``backend`` overrides it (gloo also
    reduces CUDA tensors, which lets two ranks share one GPU, where NCCL
    refuses).  On a CUDA device each rank drives ``rank_device``."""
    world = int(world_size if world_size is not None
                else _env("WORLD_SIZE", "NUM_PROCESSES", default="1"))
    rank = int(rank if rank is not None
               else _env("RANK", "PROCESS_ID", default="0"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    if init_method is None:
        addr = _env("COORDINATOR_ADDRESS")
        if _env("MASTER_ADDR") or addr is None:
            addr = (f"{_env('MASTER_ADDR', default='localhost')}:"
                    f"{_env('MASTER_PORT', default='29500')}")
        init_method = f"tcp://{addr}"
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def hosts() -> int:
    """The machines the processes run on: the world over the processes of
    this one (torchrun's ``LOCAL_WORLD_SIZE``; all of them without it)."""
    world = world_size()
    return world // int(_env("LOCAL_WORLD_SIZE", default=str(world)))


def is_main() -> bool:
    return rank() == 0


def rank_device(device=None, rank_: Optional[int] = None) -> torch.device:
    """The device of this rank: ``cuda:<LOCAL_RANK>`` (else the rank modulo
    the host's GPUs) for a CUDA device without an index; other devices
    as they are."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    r = rank() if rank_ is None else rank_
    local = int(_env("LOCAL_RANK", default=str(r)))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def comm_device() -> torch.device:
    """Where this process group's collectives take their tensors: the
    rank's GPU under NCCL, the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(model: int = 1):
    """The (data, model) grid over every process: ``world / model`` data
    ranks of ``model`` ranks each."""
    from effi_mvs_plus_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(model=model)


def mean_metrics(metrics: dict) -> dict:
    """The mean of each scalar metric over the processes; every rank gets
    the result.  Single process: the values as floats."""
    if world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                     device=comm_device())
    dist.all_reduce(t)
    return {k: float(t[i]) / world_size() for i, k in enumerate(keys)}


def partition(items: Sequence, n_parts: Optional[int] = None,
              part: Optional[int] = None):
    """Static round-robin split of work items (scans, scenes, samples);
    with no arguments over the live processes."""
    n = world_size() if n_parts is None else n_parts
    p = rank() if part is None else part
    return [x for i, x in enumerate(items) if i % n == p]


def barrier():
    """Wait for every process (a no-op for one)."""
    if world_size() > 1:
        dist.barrier()
