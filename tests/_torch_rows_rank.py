"""One rank of the row-block unit checks of
tests/test_torch_parallel_spatial.py (not collected by pytest): each
collective and each layer on this rank's block of image rows against the
same op on the whole tensor, which every rank computes from the same
seeds.  The image has 96 rows, which two ranks split as 32 + 64 (stage 1:
4 + 8 rows), so every check runs on unequal blocks.  Rank 0 writes each
check's worst relative error over the ranks to a JSON file."""

import json

import torch
import torch.distributed as dist

from effi_mvs_plus_tpu_torch import nn, parallel
from effi_mvs_plus_tpu_torch.core import geometry
from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.ops import cuda_warp
from effi_mvs_plus_tpu_torch.ops.upsample import convex_upsample
from effi_mvs_plus_tpu_torch.parallel import equivalence as E
from effi_mvs_plus_tpu_torch.parallel import mesh as par

H_IMG, B, W, C = 96, 2, 10, 3
H1 = H_IMG // 8                        # stage-1 rows


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _seeded(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


def _rows(x, axis):
    """This rank's rows of the whole tensor x along ``axis``."""
    sl = [slice(None)] * x.dim()
    sl[axis] = par.row_slice(x.shape[axis])
    return x[tuple(sl)]


def _halo(rank, world, lo, hi):
    """The halo exchange's block against the zero-padded whole tensor's
    rows, and its backward against the whole tensor's adjoint: the sum of
    every rank's cotangent at the rows it read."""
    x = _seeded(1, B, H1, W, C)
    xl = _rows(x, 1).clone().requires_grad_()
    with par.row_blocks():
        ext = par.halo(xl, lo, hi)
    start = par.row_slice(H1).start
    n = xl.shape[1]
    padded = torch.cat([x.new_zeros(B, lo, W, C), x,
                        x.new_zeros(B, hi, W, C)], 1)
    fwd = _rel(ext, padded[:, start:start + n + lo + hi])
    adj = torch.zeros_like(padded)
    for r, (a, b) in enumerate(par._blocks_at(H1)):
        adj[:, a:b + lo + hi] += _seeded(100 + r, B, b - a + lo + hi, W, C)
    ext.backward(_seeded(100 + rank, *ext.shape))
    want = adj[:, lo:lo + H1][:, start:start + n]
    return max(fwd, _rel(xl.grad, want))


def _gather(rank, world):
    """``gather_rows`` of two tensors of two levels against the whole
    tensors, and its backward against the sum of every rank's cotangent
    at the block."""
    xs = [_seeded(2, B, H1, W, C), _seeded(3, B, 2 * H1, W, C)]
    bl = [_rows(x, 1).clone().requires_grad_() for x in xs]
    outs = par.gather_rows(*bl, axis=1)
    err = max(_rel(o, x) for o, x in zip(outs, xs))
    sum(torch.sum(o * _seeded(200 + 2 * rank + i, *o.shape))
        for i, o in enumerate(outs)).backward()
    for i, (b, x) in enumerate(zip(bl, xs)):
        want = sum(_seeded(200 + 2 * r + i, *x.shape) for r in range(world))
        err = max(err, _rel(b.grad, _rows(want, 1)))
    return err


def _module(make, x, axis, out_axis=None, eval_=False):
    """A module on this rank's row block against the whole tensor's: the
    output block, the input gradient, the parameter gradients summed
    over the ranks (each rank's loss is its block's share of the whole
    one) and, in train mode, the BN running statistics."""
    out_axis = axis if out_axis is None else out_axis
    torch.manual_seed(0)
    full = make()
    torch.manual_seed(0)
    blk = make()
    for m in (full, blk):
        m.train(not eval_)
    x = x.requires_grad_()
    y = full(x)
    g = _seeded(5, *y.shape)
    torch.sum(y * g).backward()
    xl = _rows(x.detach(), axis).clone().requires_grad_()
    with par.row_blocks():
        yl = blk(xl)
    torch.sum(yl * _rows(g, out_axis)).backward()
    err = max(_rel(yl, _rows(y.detach(), out_axis)),
              _rel(xl.grad, _rows(x.grad, axis)))
    for p, q in zip(blk.parameters(), full.parameters()):
        grad = p.grad.clone()
        dist.all_reduce(grad)
        err = max(err, _rel(grad, q.grad))
    for (name, a), (_, b) in zip(blk.named_buffers(), full.named_buffers()):
        if a.is_floating_point():
            err = max(err, _rel(a, b))
    return err


def _conv2d(k, stride, h, **kw):
    return _module(lambda: nn.ConvBlock(2, C, 4, k, stride, k // 2, **kw),
                   _seeded(4, B, h, W, C), 1)


def _conv3d(h, **kw):
    return _module(lambda: nn.ConvBlock(3, C, 4, **kw),
                   _seeded(4, B, 4, h, W, C), 2)


def _conv7(rank, world):
    """ProjectionInput's 7x7 convd1 (3 halo rows) on a 4-row block."""
    return _module(lambda: nn.Conv(2, 1, 4, 7, padding=3),
                   _seeded(6, B, H1, W, 1), 1)


class _Upsample(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mask = torch.nn.Parameter(_seeded(7, B, H1, W, 9 * 4))

    def forward(self, value):
        return convex_upsample(value, self.mask if value.shape[1] == H1
                               else _rows(self.mask, 1), 2)


def _upsample(rank, world):
    return _module(_Upsample, _seeded(8, B, H1, W), 1)


def _gru(rank, world):
    """The ConvGRU (plain version on the CPU) on a block of h and x."""
    hd = 16

    class Step(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gru = blocks.ConvGRU(hd, hd)

        def forward(self, hx):
            return self.gru(hx[..., :hd], hx[..., hd:])
    hx = torch.cat([torch.tanh(_seeded(9, B, H1, W, hd)),
                    torch.relu(_seeded(10, B, H1, W, hd))], -1)
    return _module(Step, hx, 1)


def _warp_inputs():
    imgs, proj_ms, dv = E.rig(B, 3, H_IMG, 8 * W)
    P = geometry.compose_projection(torch.from_numpy(proj_ms["stage1"]))
    rots, trs = geometry.relative_projection(P[:, 1:],
                                             P[:, :1].expand_as(P[:, 1:]))
    drs = geometry.depth_range_samples_global(torch.from_numpy(dv), 8, 1, 1)
    depth = (1.0 / drs).expand(B, 8, H1, W)
    return (_seeded(11, B, H1, W, 8), _seeded(12, B, 2, H1, W, 8), rots,
            trs, depth)


def _warp(rank, world):
    """The plain warp of this rank's reference rows (offset y0) against
    the whole source maps, against the whole image's rows; its autograd:
    d_ref against the whole d_ref's rows, d_src summed over the ranks
    against the whole d_src."""
    ref, src, rots, trs, depth = _warp_inputs()
    r = ref.clone().requires_grad_()
    s = src.clone().requires_grad_()
    whole = cuda_warp.warp_correlate_views(r, s, rots, trs, depth)
    g = _seeded(13, *whole.shape)
    torch.sum(whole * g).backward()
    rows = par.row_slice(H1)
    rl = ref[:, rows].clone().requires_grad_()
    sl = src.clone().requires_grad_()
    got = cuda_warp.warp_correlate_views(rl, sl, rots, trs, depth[:, :, rows],
                                         rows.start)
    torch.sum(got * g[:, :, :, rows]).backward()
    d_src = sl.grad.clone()
    dist.all_reduce(d_src)
    return max(_rel(got, whole.detach()[:, :, :, rows]),
               _rel(rl.grad, r.grad[:, rows]), _rel(d_src, s.grad))


def _fpn(fused):
    """The FPN on this rank's rows of the images against the whole
    images: in train mode (BN statistics over the group), or in eval
    mode with the stem chain forced (its plain version on the CPU, with
    chain-deep halos)."""
    x = torch.rand(B, H_IMG, 8 * W, 3, generator=torch.Generator(
    ).manual_seed(14))
    torch.manual_seed(0)
    full = blocks.FeatureNet((4, 8, 8, 16), (8, 8, 8)).train(not fused)
    torch.manual_seed(0)
    blk = blocks.FeatureNet((4, 8, 8, 16), (8, 8, 8)).train(not fused)
    saved = blocks.stem_chain_applies
    if fused:
        blocks.stem_chain_applies = lambda x, training: True
    try:
        with torch.set_grad_enabled(not fused):
            want = full(x)
            with par.row_blocks():
                got = blk(_rows(x, 1))
    finally:
        blocks.stem_chain_applies = saved
    return max(_rel(got[k], _rows(want[k], 1)) for k in want)


def _reg_fused(kind):
    """CostRegNet or CSPBlock in eval mode with the fused 3-D path forced
    (its plain version on the CPU), each layer on this rank's rows of the
    volumes with its halo, against the whole volumes'."""
    torch.manual_seed(0)
    m = (blocks.CostRegNet() if kind == "reg" else blocks.CSPBlock()).eval()
    vols = ((_seeded(15, B, 4, H1, 8, 1),) if kind == "reg" else
            (_seeded(15, B, 4, 2 * H1, W, 1), _seeded(16, B, 4, H1, W // 2, 1)))
    saved = blocks.reg_applies
    blocks.reg_applies = lambda x, training: True
    try:
        with torch.no_grad():
            want = m(*vols)
            with par.row_blocks():
                got = m(*(_rows(v, 2) for v in vols))
    finally:
        blocks.reg_applies = saved
    if kind != "reg":
        got, want = (got,), (want,)
    return max(_rel(g, _rows(w, 2)) for g, w in zip(got, want))


CHECKS = {
    "halo_1_1": lambda *a: _halo(*a, 1, 1),
    "halo_2_1": lambda *a: _halo(*a, 2, 1),
    "halo_0_1": lambda *a: _halo(*a, 0, 1),
    "halo_3_3": lambda *a: _halo(*a, 3, 3),
    "gather": _gather,
    "conv2d_stride1": lambda *a: _conv2d(3, 1, H1),
    "conv2d_stride2": lambda *a: _conv2d(3, 2, 2 * H1),
    "conv2d_5x5_stride2": lambda *a: _conv2d(5, 2, 2 * H1),
    "conv2d_1x1": lambda *a: _conv2d(1, 1, H1, relu=False),
    "conv2d_7x7": _conv7,
    "conv3d_stride1": lambda *a: _conv3d(H1),
    "conv3d_stride2": lambda *a: _conv3d(H1, stride=2),
    "deconv3d_stride2": lambda *a: _conv3d(H1 // 2, stride=2,
                                           transpose=True, output_padding=1),
    "deconv3d_stride122": lambda *a: _conv3d(H1 // 2, stride=(1, 2, 2),
                                             transpose=True,
                                             output_padding=(0, 1, 1)),
    "convex_upsample": _upsample,
    "conv_gru": _gru,
    "warp_row_offset": _warp,
    "fpn_train": lambda *a: _fpn(False),
    "fpn_stem_chain_eval": lambda *a: _fpn(True),
    "cost_reg_fused_eval": lambda *a: _reg_fused("reg"),
    "csp_fused_eval": lambda *a: _reg_fused("csp"),
}


def main(rank, world, port, out):
    torch.set_num_threads(1)
    parallel.initialize(backend="gloo", device="cpu",
                        init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
    pol = parallel.make_policy(parallel.make_mesh(1, world), "spatial")
    errs = {}
    for name, check in CHECKS.items():
        with par.use_policy(pol), par.image_rows(H_IMG):
            e = torch.tensor(check(rank, world), dtype=torch.float64)
        dist.all_reduce(e, op=dist.ReduceOp.MAX)
        errs[name] = float(e)
    # the plain warp of a block, bitwise against the whole image's rows
    with par.use_policy(pol), par.image_rows(H_IMG):
        ref, src, rots, trs, depth = _warp_inputs()
        rows = par.row_slice(H1)
        whole = cuda_warp.warp_correlate_views(ref, src, rots, trs, depth)
        got = cuda_warp.warp_correlate_views(
            ref[:, rows], src, rots, trs, depth[:, :, rows], rows.start)
        e = torch.tensor(float((got - whole[:, :, :, rows]).abs().max()),
                         dtype=torch.float64)
    dist.all_reduce(e, op=dist.ReduceOp.MAX)
    errs["warp_row_offset_max_abs"] = float(e)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(errs, f)
    dist.barrier()
    dist.destroy_process_group()
