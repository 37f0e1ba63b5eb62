"""One rank of the depth,spatial unit checks of
tests/test_torch_parallel_depth_spatial.py (not collected by pytest).
Under a ``depth,spatial`` policy, inside the forward's image rows and row
blocks, the 3-D part runs on this rank's D-block of a volume over all
rows (``row_blocks(False)``): each module there against the same module
on the whole volume, which every rank computes from the same seeds; the
BN element counts against the whole tensor's; and a module inside both
block contexts at once must raise.  Rank 0 writes each check's worst
relative error over the ranks to a JSON file; also ``planted_sync``, the
fault the gate must catch under this layout (a setup for
``equivalence.spawn``)."""

import json

import torch
import torch.distributed as dist

from effi_mvs_plus_tpu_torch import nn, parallel
from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.parallel import mesh as par

# 64 image rows over two ranks: 32 + 32 (stage 1: 4 + 4); the volumes
# have 8 hypotheses (4 + 4, CostRegNet's multiple) and 8 rows
H_IMG, B, D, H, W = 64, 2, 8, 8, 8


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _seeded(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


def _block(x, rank, world):
    n = x.shape[1] // world
    return x[:, rank * n:(rank + 1) * n]


def _volume_module(make, xs, rank, world):
    """A train-mode module of the 3-D part on this rank's D-block of its
    inputs over all rows, inside ``row_blocks(False)`` as the forward
    runs it, against the whole volume's: every output's block, the input
    gradients, the parameter gradients summed over the ranks (each
    rank's loss is its block's share of the whole one) and the BN
    running statistics.  In float64, so that the chain of nine
    convolutions and BN layers reads the layout, not fp32's summation
    order."""
    torch.manual_seed(0)
    full = make().double().train()
    torch.manual_seed(0)
    blk = make().double().train()
    xs = [x.double().requires_grad_() for x in xs]
    with par.use_policy(None):
        ys = full(*xs)
    ys = ys if isinstance(ys, tuple) else (ys,)
    gs = [_seeded(20 + i, *y.shape).double() for i, y in enumerate(ys)]
    sum(torch.sum(y * g) for y, g in zip(ys, gs)).backward()
    xl = [_block(x.detach(), rank, world).clone().requires_grad_()
          for x in xs]
    with par.row_blocks(False):
        yl = blk(*xl)
    yl = yl if isinstance(yl, tuple) else (yl,)
    sum(torch.sum(y * _block(g, rank, world))
        for y, g in zip(yl, gs)).backward()
    err = max(_rel(a, _block(b, rank, world)) for a, b in zip(yl, ys))
    err = max(err, *(_rel(a.grad, _block(b.grad, rank, world))
                     for a, b in zip(xl, xs)))
    for p, q in zip(blk.parameters(), full.parameters()):
        grad = p.grad.clone()
        dist.all_reduce(grad)
        err = max(err, _rel(grad, q.grad))
    for (_, a), (_, b) in zip(blk.named_buffers(), full.named_buffers()):
        if a.is_floating_point():
            err = max(err, _rel(a, b))
    return err


def _cost_reg_net(rank, world):
    return _volume_module(blocks.CostRegNet,
                          [_seeded(1, B, D, H, W, 1)], rank, world)


def _csp_block(rank, world):
    return _volume_module(blocks.CSPBlock,
                          [_seeded(2, B, D, H, W, 1),
                           _seeded(3, B, D, H // 2, W // 2, 1)], rank, world)


def _bn_counts(rank, world):
    """The elements per channel that BN divides by: a D-block over all
    rows (inside ``row_blocks(False)``) counts the whole volume's, and a
    row block (stage 1: 4 of 8 rows) the whole tensor's."""
    n = B * (D // world) * H * W
    with par.row_blocks(False), par.depth_blocks():
        err = abs(par.block_count(n, H) - B * D * H * W) / (B * D * H * W)
    h = H // world
    err = max(err, abs(par.block_count(B * h * W, h) - B * H * W)
              / (B * H * W))
    return float(err)


def _both_contexts_raise(rank, world):
    """A 3-D convolution and a BN count inside ``depth_blocks`` and
    ``row_blocks`` at once raise: 0 where both raise, 1 otherwise."""
    x = _block(_seeded(4, B, D, H, W, 1), rank, world)
    raised = 0
    with par.depth_blocks():
        for fn in (lambda: nn.Conv(3, 1, 2, 3, padding=1)(x),
                   lambda: par.block_count(8, 4)):
            try:
                fn()
            except RuntimeError as e:
                raised += "depth_blocks and row_blocks" in str(e)
    return float(raised != 2)


CHECKS = {
    "cost_reg_net": _cost_reg_net,
    "csp_block": _csp_block,
    "bn_counts": _bn_counts,
    "both_contexts_raise": _both_contexts_raise,
}


def planted_sync():
    """A fault for ``equivalence.spawn``'s ``setup``: under
    ``depth,spatial`` the gradients are averaged over the model group
    only for the modules the depth layout shards, as under ``depth``
    alone, so the row-blocked GRU, context net and FPN keep each rank's
    own share twice over."""
    sync = par.ShardingPolicy.sync_gradients

    def depth_only(self, model):
        spatial, self.shard_spatial = self.shard_spatial, False
        try:
            sync(self, model)
        finally:
            self.shard_spatial = spatial
    par.ShardingPolicy.sync_gradients = depth_only


def main(rank, world, port, out):
    torch.set_num_threads(1)
    parallel.initialize(backend="gloo", device="cpu",
                        init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
    pol = parallel.make_policy(parallel.make_mesh(1, world), "depth,spatial")
    errs = {}
    for name, check in CHECKS.items():
        with par.use_policy(pol), par.image_rows(H_IMG), par.row_blocks():
            e = torch.tensor(check(rank, world), dtype=torch.float64)
        dist.all_reduce(e, op=dist.ReduceOp.MAX)
        errs[name] = float(e)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(errs, f)
    dist.barrier()
    dist.destroy_process_group()
