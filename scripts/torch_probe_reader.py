"""Where the streaming reader's cost lands in a DTU training step on the
card: the step at the DTU training config (640x512, 5 views, B=4, fp32,
``model_dtu.npz``) on the tree ``chip_smoke.py`` writes for its
``device_cache`` phase (12 views, 7 lights), fed five ways in turns, each
step timed by CUDA events (the batch's upload is inside the step):

* ``cache``        — ``DeviceCacheLoader`` batches, already on the card;
* ``loader``       — ``Loader`` batches (8 reader threads), as
                     ``cli/train.py`` feeds them: upload and concurrent
                     reading;
* ``host``         — the same ``Loader``'s batches read into host memory
                     first: the pageable upload without concurrent
                     reading;
* ``pinned``       — those batches in pinned host memory;
* ``cache_reader`` — cache batches while a ``Loader`` (8 threads) reads
                     the set in the background and drops its batches:
                     concurrent reading without the upload.

    python3 scripts/torch_probe_reader.py [--rounds 2] [--steps 10]

Needs a CUDA GPU and nvcc (the kernels build first); about two minutes.
Prints one JSON line a case and round, then the card's name and power
limit.
"""

import argparse
import os
import statistics
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from effi_mvs_plus_tpu_torch.data.datasets import DTUTrainDataset  # noqa: E402
from effi_mvs_plus_tpu_torch.data.device_cache import (  # noqa: E402
    DeviceCacheLoader)
from effi_mvs_plus_tpu_torch.data.loader import Loader  # noqa: E402
from effi_mvs_plus_tpu_torch.device import resolve_device  # noqa: E402
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint  # noqa: E402
from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig  # noqa: E402
from effi_mvs_plus_tpu_torch.ops import _kernels  # noqa: E402
from effi_mvs_plus_tpu_torch.train import trainer as T  # noqa: E402
from effi_mvs_plus_tpu_torch.train.optim import make_optimizer  # noqa: E402


def pinned(batch):
    if isinstance(batch, dict):
        return {k: pinned(v) for k, v in batch.items()}
    return torch.from_numpy(batch).pin_memory()


def timed(step, batches, n, warm=2):
    """CUDA-event ms of n steps after ``warm`` steps, fed from
    ``batches`` (an iterator)."""
    out = []
    for i in range(warm + n):
        batch = next(batches)
        batch.pop("filename", None)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch)
        end.record()
        end.synchronize()
        if i >= warm:
            out.append(start.elapsed_time(end))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    _kernels.build()
    B, V = chip_smoke.TRAIN["B"], chip_smoke.TRAIN["V"]
    model = EffiMVS(EffiMVSConfig())
    model.load_state_dict(load_npz_checkpoint(os.path.join(
        ROOT, "checkpoints", "model_dtu.npz")), strict=True)
    model.to(dev)
    opt, sched, _ = make_optimizer(model, 1e-3, 10000)
    step = T.make_train_step(model, opt, sched, seed=1, device=dev)
    with tempfile.TemporaryDirectory() as tree:
        listfile = chip_smoke.write_dtu_tree(tree)
        ds = DTUTrainDataset(tree, listfile, "train", V)
        cache = DeviceCacheLoader(ds, B, shuffle=True, seed=1,
                                  drop_last=True, device=dev)
        need = args.steps + 2

        def loader(workers=8):
            return Loader(ds, B, shuffle=True, seed=1, drop_last=True,
                          num_workers=workers)
        host = [b for _, b in zip(range(need), loader())]
        pin = [pinned({k: v for k, v in b.items() if k != "filename"})
               for b in host]

        def epochs(make):
            while True:
                yield from make()

        def cache_reader():
            stop = threading.Event()

            def drain():
                while not stop.is_set():
                    for _ in loader():
                        if stop.is_set():
                            break
            t = threading.Thread(target=drain, daemon=True)
            t.start()
            time.sleep(1.0)              # the readers at work first
            try:
                return timed(step, epochs(lambda: iter(cache)), args.steps)
            finally:
                stop.set()
                t.join()

        cases = {
            "cache": lambda: timed(step, epochs(lambda: iter(cache)),
                                   args.steps),
            "loader": lambda: timed(step, epochs(lambda: iter(loader())),
                                    args.steps),
            "host": lambda: timed(step, iter(dict(b) for b in host),
                                  args.steps),
            "pinned": lambda: timed(step, iter(dict(b) for b in pin),
                                    args.steps),
            "cache_reader": cache_reader,
        }
        for r in range(args.rounds):
            for name, run in cases.items():
                ms = run()
                chip_smoke.log({"case": name, "round": r, "batch": B,
                                "step_ms_median": statistics.median(ms),
                                "samples_per_s": B / (statistics.median(ms)
                                                      / 1e3),
                                "step_ms": [round(x, 3) for x in ms]})
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
