"""One rank of tests/test_torch_device_cache.py's two-rank check (not
collected by pytest): a (data 2 x model 1) grid of gloo CPU ranks, each
building the train CLI's device caches (``cli/train.py``
``device_cache_loaders``) and saving the batches it assembles, so that
the test can hold the ranks' rows to the single process's batches."""

import torch

from effi_mvs_plus_tpu_torch import parallel
from effi_mvs_plus_tpu_torch.cli import train as cli


def main(rank, world, port, ds_args, batch, out):
    torch.set_num_threads(1)
    parallel.initialize(backend="gloo", device="cpu",
                        init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
    from effi_mvs_plus_tpu_torch.data.datasets import DTUTrainDataset
    pol = parallel.make_policy(parallel.make_mesh(world, 1), "views")
    args = cli.build_parser().parse_args(
        ["--batch_size", str(batch), "--seed", "1"])
    train_ds = DTUTrainDataset(*ds_args["train"], **ds_args["kw"])
    test_ds = DTUTrainDataset(*ds_args["test"], **ds_args["kw"])
    train, test = cli.device_cache_loaders(args, train_ds, test_ds, batch,
                                           pol, torch.device("cpu"))
    torch.save({"train": list(train), "test": list(test)},
               f"{out}.{rank}.pt")
    parallel.barrier()
    torch.distributed.destroy_process_group()
