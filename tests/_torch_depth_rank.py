"""One rank of the depth-sharding unit checks of
tests/test_torch_parallel_depth.py (not collected by pytest): each
collective and each 3-D layer on this rank's D-block against the same op
on the whole volume, which every rank computes from the same seeds.
Rank 0 writes each check's worst relative error over the ranks to a JSON
file."""

import json

import torch
import torch.distributed as dist

from effi_mvs_plus_tpu_torch import nn, parallel
from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.models.effi_mvs import _sweep_entropy
from effi_mvs_plus_tpu_torch.parallel import mesh as par

B, D, H, W, C = 2, 8, 5, 6, 3


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _seeded(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


def _halo(pol, rank, world, lo, hi):
    """The halo exchange's block against the zero-padded whole volume's
    slice, and its backward against the whole volume's adjoint: the sum
    of every rank's cotangent at the planes it read."""
    n = D // world
    x = _seeded(1, B, D, H, W, C)
    xl = x[:, rank * n:(rank + 1) * n].clone().requires_grad_()
    with par.use_policy(pol), par.depth_blocks():
        ext = par.halo(xl, lo, hi)
    padded = torch.cat([x.new_zeros(B, lo, H, W, C), x,
                        x.new_zeros(B, hi, H, W, C)], 1)
    fwd = _rel(ext, padded[:, rank * n:(rank + 1) * n + lo + hi])
    adj = torch.zeros_like(padded)
    for r in range(world):
        adj[:, r * n:(r + 1) * n + lo + hi] += _seeded(100 + r, *ext.shape)
    ext.backward(_seeded(100 + rank, *ext.shape))
    want = adj[:, lo:lo + D][:, rank * n:(rank + 1) * n]
    return max(fwd, _rel(xl.grad, want))


def _gather(pol, rank, world):
    """``gather_depths`` of two blocks against the whole volumes, and its
    backward against the sum of every rank's cotangent at the block."""
    n = D // world
    xs = [_seeded(s, B, D, H, W) for s in (2, 3)]
    blocks = [x[:, rank * n:(rank + 1) * n].clone().requires_grad_()
              for x in xs]
    outs = pol.gather_depths(blocks)
    err = max(_rel(o, x) for o, x in zip(outs, xs))
    sum(torch.sum(o * _seeded(200 + 2 * rank + i, *o.shape))
        for i, o in enumerate(outs)).backward()
    for i, b in enumerate(blocks):
        want = sum(_seeded(200 + 2 * r + i, B, D, H, W)
                   for r in range(world))[:, rank * n:(rank + 1) * n]
        err = max(err, _rel(b.grad, want))
    return err


def _layer(pol, rank, world, **kw):
    """A train-mode 3-D ConvBlock (conv + BN + ReLU) on this rank's
    D-block against the whole volume's: the output block, the input
    gradient, the weight and BN gradients summed over the ranks (each
    rank's loss is its block's share of the whole one) and the running
    statistics."""
    torch.manual_seed(0)
    full = nn.ConvBlock(3, C, 4, **kw).train()
    torch.manual_seed(0)
    blk = nn.ConvBlock(3, C, 4, **kw).train()
    n = D // world
    x = _seeded(4, B, D, H, W, C).requires_grad_()
    y = full(x)
    no = y.shape[1] // world
    g = _seeded(5, *y.shape)
    torch.sum(y * g).backward()

    xl = x.detach()[:, rank * n:(rank + 1) * n].clone().requires_grad_()
    with par.use_policy(pol), par.depth_blocks():
        yl = blk(xl)
    torch.sum(yl * g[:, rank * no:(rank + 1) * no]).backward()
    err = max(_rel(yl, y[:, rank * no:(rank + 1) * no]),
              _rel(xl.grad, x.grad[:, rank * n:(rank + 1) * n]))
    for p, q in zip(blk.parameters(), full.parameters()):
        grad = p.grad.clone()
        dist.all_reduce(grad)
        err = max(err, _rel(grad, q.grad))
    for name in ("running_mean", "running_var"):
        err = max(err, _rel(getattr(blk.bn, name), getattr(full.bn, name)))
    return err


def _entropy(pol, rank, world):
    """The stage-1 entropy over D of a block of every view's correlations,
    with the max and sums over D from the group, against the whole
    sweep's."""
    n = D // world
    sims = _seeded(6, B, 3, D, H, W) * 4
    with par.use_policy(pol):
        got = _sweep_entropy(sims[:, :, rank * n:(rank + 1) * n])
    return _rel(got, _sweep_entropy(sims))


def _reg_fused(pol, rank, world, kind):
    """CostRegNet or CSPBlock in eval mode with the fused 3-D path forced
    (its plain version on the CPU), each layer on this rank's D-block of
    the volumes with its halo, against the whole volumes'."""
    torch.manual_seed(0)
    m = (blocks.CostRegNet() if kind == "reg" else blocks.CSPBlock()).eval()
    vols = ((_seeded(7, B, D, 8, 8, 1),) if kind == "reg" else
            (_seeded(7, B, D, 8, 8, 1), _seeded(8, B, D, 4, 4, 1)))
    n = D // world
    saved = blocks.reg_applies
    blocks.reg_applies = lambda x, training: True
    try:
        with torch.no_grad():
            want = m(*vols)
            with par.use_policy(pol):
                got = m(*(v[:, rank * n:(rank + 1) * n] for v in vols))
    finally:
        blocks.reg_applies = saved
    if kind != "reg":
        got, want = (got,), (want,)
    return max(_rel(g, w[:, rank * n:(rank + 1) * n])
               for g, w in zip(got, want))


CHECKS = {
    "halo_1_1": lambda *a: _halo(*a, 1, 1),
    "halo_1_0": lambda *a: _halo(*a, 1, 0),
    "halo_0_1": lambda *a: _halo(*a, 0, 1),
    "halo_2_1": lambda *a: _halo(*a, 2, 1),
    "gather": _gather,
    "conv_stride1": lambda *a: _layer(*a),
    "conv_stride2": lambda *a: _layer(*a, stride=2),
    "deconv_stride2": lambda *a: _layer(*a, stride=2, transpose=True,
                                        output_padding=1),
    "deconv_stride122": lambda *a: _layer(*a, stride=(1, 2, 2),
                                          transpose=True,
                                          output_padding=(0, 1, 1)),
    "sweep_entropy": _entropy,
    "cost_reg_fused_eval": lambda *a: _reg_fused(*a, "reg"),
    "csp_fused_eval": lambda *a: _reg_fused(*a, "csp"),
}


def main(rank, world, port, out):
    torch.set_num_threads(1)
    parallel.initialize(backend="gloo", device="cpu",
                        init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
    pol = parallel.make_policy(parallel.make_mesh(1, world), "depth")
    errs = {}
    for name, check in CHECKS.items():
        e = torch.tensor(check(pol, rank, world), dtype=torch.float64)
        dist.all_reduce(e, op=dist.ReduceOp.MAX)
        errs[name] = float(e)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(errs, f)
    dist.barrier()
    dist.destroy_process_group()
