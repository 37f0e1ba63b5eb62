"""Data, source-view, depth and image-row parallelism over a (data, model)
grid of ranks.

The port of ``effi_mvs_plus_tpu/parallel/mesh.py``.  Rank ``r`` sits at
(data ``r // model``, model ``r % model``), and each axis has its own
process group.

* ``data``  — each data rank takes its rows of the global batch.  The
  step still computes what the whole batch computes: train-mode BN
  all-reduces its sums over the data group (``reduce_data``), the loss
  its masked sums, the dropout masks are drawn for the global batch and
  each rank keeps its rows (``dropout_rows``), and the gradients are
  averaged over the group before the optimizer (``sync_gradients``).
* ``model``, layout ``views`` — each model rank runs the FPN and the
  per-view warps and ``PixelwiseNet`` on its contiguous block of the
  source views (``local_source_views``; every rank also runs the
  reference view), and the view-weighted sums are all-reduced over the
  group (``sum_views``).  Per-view BN statistics stay with the views a
  rank holds; the running statistics gather every view's, in order
  (``gather_view_stats``).
* ``model``, layout ``depth`` — each model rank holds a contiguous block
  of the cost volume's hypotheses (``depth_block``): alone, it warps and
  correlates that block of every view (the stage-1 entropy over D takes
  its max and sums from the group, ``sweep_max`` / ``sweep_sum``); with
  ``views`` (the JAX CLI's default ``views,depth``), it keeps its block
  of the view sums (``depth_slices``).  The 3-D U-Net and the CSP blocks
  run on the block (``depth_blocks``): each 3-D convolution takes the
  planes its kernel reaches past the block's edges from the neighbouring
  ranks (``halo``), and train-mode BN sums over the group as well.
  The regularised volumes are gathered along D (``gather_depths``) and
  the rest of the network runs replicated.
* ``model``, layout ``spatial`` — each model rank holds a block of image
  rows (``row_blocks_of``) of every activation: the images, the FPN's
  levels, the per-stage features, the GRU hiddens, the cost volumes.
  Within ``row_blocks`` every convolution takes the rows its kernel
  reaches past the block's edges from the neighbouring ranks
  (``halo``) and train-mode BN sums over the group.  A block of
  reference rows is warped against the whole source features, gathered
  along H (``gather_rows``); the depth maps and the confidence are
  gathered at the end.  With ``views`` (``views,spatial``), as in JAX,
  the views take precedence for the FPN, the warps and ``PixelwiseNet``,
  which run a block of the views over all rows, and each rank keeps its
  rows of the view sums from there on.
* ``model``, layouts ``depth,spatial`` and ``views,depth,spatial`` — as
  in JAX, one model axis and no tensor split along two: the 2-D
  activations (the FPN, the context net, ``PixelwiseNet``, the GRU) are
  split by rows, the cost volumes by hypotheses.  The warps run on the
  rank's D-block of every view (with views: all D of its views) over all
  rows, against reference and source features gathered along H; the
  3-D U-Net and the CSP blocks run on the D-block over all rows
  (``row_blocks(False)``), and after ``gather_depths`` each rank keeps
  its rows of the whole volumes for the rest.  A module inside both
  ``depth_blocks`` and ``row_blocks`` raises (``_blocked``).

GSPMD inserts these collectives for the JAX package.  The port writes
them out, each as an all_reduce of zero-padded blocks (exact, and the one
collective that both backends take on either device: gloo gathers no
CUDA tensors).  Unlike GSPMD, which pads an uneven split, the port
refuses a split of D into blocks the halos cannot serve
(``depth_split_error``), and cuts image rows at the granularity the
network forces, which may leave the blocks unequal, refusing only a
split that leaves a rank no rows (``row_split_error``).

The model calls the module-level hooks, which do nothing unless a
``ShardingPolicy`` is active (``use_policy``), so a single process pays
nothing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist

from effi_mvs_plus_tpu_torch.parallel import distributed as D

# the modules whose gradient flows only through a rank's own source views
# (layout views) or its own block of hypotheses (layout depth, with or
# without views); the rest of the network runs replicated on every model
# rank
VIEW_SHARDED = ("feature", "PixelwiseNet")
DEPTH_SHARDED = VIEW_SHARDED + ("cost_regularization", "CSP_R1", "CSP_R2",
                                "CSP_C1", "CSP_C2")


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the gradients over the
    group too (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _with_axis(shape, axis, n):
    return shape[:axis] + (n,) + shape[axis + 1:]


class _Halo(torch.autograd.Function):
    """A block (..., n, ...) along ``axis`` -> (..., lo + n + hi, ...):
    the last ``lo`` entries of the left neighbour's block, the block, the
    first ``hi`` entries of the right neighbour's, zeros past the ends of
    the whole tensor.  Every rank puts its edge entries in its slot of a
    zero buffer and one all_reduce hands each rank every slot.  The
    backward returns each halo's gradient to the rank that owns those
    entries, the same way.  Along D or along H (``halo``); blocks may
    differ in length, the slots do not."""

    @staticmethod
    def forward(ctx, x, axis, lo, hi, group, rank, size):
        ctx.args = axis, lo, hi, group, rank, size
        n, shape = x.shape[axis], tuple(x.shape)
        if n < max(lo, hi):
            raise ValueError(f"a block of {n} along axis {axis} cannot "
                             f"serve a halo of {lo} + {hi}")
        slots = x.new_zeros((size,) + _with_axis(shape, axis, lo + hi))
        mine = slots[rank]
        mine.narrow(axis, 0, lo).copy_(x.narrow(axis, n - lo, lo))
        mine.narrow(axis, lo, hi).copy_(x.narrow(axis, 0, hi))
        dist.all_reduce(slots, group=group)
        left = (slots[rank - 1].narrow(axis, 0, lo) if rank > 0
                else x.new_zeros(_with_axis(shape, axis, lo)))
        right = (slots[rank + 1].narrow(axis, lo, hi) if rank < size - 1
                 else x.new_zeros(_with_axis(shape, axis, hi)))
        return torch.cat([left, x, right], axis)

    @staticmethod
    def backward(ctx, g):
        axis, lo, hi, group, rank, size = ctx.args
        n = g.shape[axis] - lo - hi
        gx = g.narrow(axis, lo, n).clone(
            memory_format=torch.contiguous_format)
        slots = g.new_zeros((size,) + _with_axis(tuple(g.shape), axis,
                                                 lo + hi))
        if rank > 0:
            slots[rank - 1].narrow(axis, 0, lo).copy_(g.narrow(axis, 0, lo))
        if rank < size - 1:
            slots[rank + 1].narrow(axis, lo, hi).copy_(
                g.narrow(axis, lo + n, hi))
        dist.all_reduce(slots, group=group)
        gx.narrow(axis, n - lo, lo).add_(slots[rank].narrow(axis, 0, lo))
        gx.narrow(axis, 0, hi).add_(slots[rank].narrow(axis, lo, hi))
        return gx, None, None, None, None, None, None


class Mesh:
    """A (data, model) grid over the process group: this rank's place on
    it and one process group along each axis (None for an axis of one)."""

    def __init__(self, data, model, data_group=None, model_group=None):
        self.data, self.model = data, model
        self.data_rank, self.model_rank = divmod(D.rank(), model)
        self.data_group, self.model_group = data_group, model_group


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The (data, model) grid over every process (``data`` defaults to
    ``world / model``).  Every rank must call it, in the same order."""
    world = D.world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} grid needs {data * model} "
                         f"processes, not {world}")
    r = D.rank()
    groups = {}
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == r // model:
                groups["model"] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == r % model:
                groups["data"] = g
    return Mesh(data, model, groups.get("data"), groups.get("model"))


def view_blocks(n_src, parts):
    """Contiguous blocks [start, stop) of ``n_src`` source views over
    ``parts`` ranks, the first ``n_src % parts`` one view longer."""
    if parts > n_src:
        raise ValueError(f"{n_src} source views cannot be split over "
                         f"{parts} model ranks")
    q, r = divmod(n_src, parts)
    starts = [m * q + min(m, r) for m in range(parts + 1)]
    return list(zip(starts[:-1], starts[1:]))


# the JAX package's model-axis layouts; a policy takes any non-empty
# subset of them, as the JAX CLI builds it
PORTED_LAYOUTS = ("views", "depth", "spatial")


def layout_kinds(spec):
    """The model-axis layouts of a comma list such as ``"views,depth"``;
    raises ValueError, with the reason, for an unknown layout and for an
    empty list (a model axis that shards nothing would only repeat the
    work on every rank)."""
    kinds = {k.strip() for k in spec.split(",") if k.strip()}
    if not kinds:
        raise ValueError("no model-axis layout given; the port has "
                         "views, depth and spatial")
    for k in sorted(kinds):
        if k not in PORTED_LAYOUTS:
            raise ValueError(f"unknown layout {k!r}; the port has views, "
                             f"depth and spatial")
    return kinds


# image rows a row block holds a multiple of: the FPN halves H three times
# (stage 1 is 1/8 of the image) and CostRegNet twice more
ROW_MULTIPLE = 32


def row_blocks_of(H, parts):
    """Contiguous blocks [start, stop) of ``H`` image rows over ``parts``
    ranks, each a multiple of ``ROW_MULTIPLE`` rows and as equal as that
    allows, the last ``(H / ROW_MULTIPLE) % parts`` one unit longer;
    raises ValueError, with the reason, for a split that leaves a rank no
    rows (``row_split_error``)."""
    why = row_split_error(H, parts)
    if why:
        raise ValueError(why)
    q, r = divmod(H // ROW_MULTIPLE, parts)
    starts = [ROW_MULTIPLE * (m * q + max(0, m - (parts - r)))
              for m in range(parts + 1)]
    return list(zip(starts[:-1], starts[1:]))


def row_split_error(H, parts):
    """Why ``H`` image rows cannot be cut into ``parts`` blocks of a
    multiple of ``ROW_MULTIPLE`` rows, none empty, or None."""
    if H % ROW_MULTIPLE == 0 and H // ROW_MULTIPLE >= parts:
        return None
    return (f"{H} image rows do not give each of {parts} model ranks a "
            f"block of a multiple of {ROW_MULTIPLE} rows (the FPN and "
            f"CostRegNet halve H five times; stage 1 has {H / 8:g} rows); "
            f"GSPMD pads such a split, the port refuses it: fit "
            f"--model_parallel or use --shard_policy views")


def depth_split_error(D, parts, multiple=1):
    """Why ``D`` hypotheses cannot be split into ``parts`` blocks that
    each run the 3-D layers on their own planes, or None.  A block must
    be a whole number of planes, and a multiple of ``multiple`` where the
    layers halve D (2 for each stride-2 level along D), so that every
    level's blocks start on the planes the strides sample."""
    if D % parts == 0 and (D // parts) % multiple == 0:
        return None
    what = ("evenly" if multiple == 1 else
            f"into blocks of a multiple of {multiple} planes (the 3-D "
            f"U-Net halves D {multiple.bit_length() - 1} times)")
    return (f"{D} hypotheses do not split over {parts} model ranks "
            f"{what}; GSPMD pads such a split, the port refuses it: fit "
            f"--model_parallel or --ndepths, or use --shard_policy views")


def make_policy(mesh, spec):
    """The ``ShardingPolicy`` of a comma list of layouts (``layout_kinds``)
    on ``mesh``, as the JAX CLI builds it."""
    kinds = layout_kinds(spec)
    return ShardingPolicy(mesh, shard_views="views" in kinds,
                          shard_depth="depth" in kinds,
                          shard_spatial="spatial" in kinds)


class ShardingPolicy:
    """The layouts the model hooks apply on a mesh: the batch over the
    data axis; over the model axis the source views (``shard_views``),
    the cost volume's hypotheses (``shard_depth``), the image rows
    (``shard_spatial``), or several of them, each tensor along one axis.
    A mesh of one model rank shards nothing."""

    def __init__(self, mesh: Mesh, shard_views: bool = True,
                 shard_depth: bool = False, shard_spatial: bool = False):
        self.mesh = mesh
        self.shard_views = shard_views and mesh.model > 1
        self.shard_depth = shard_depth and mesh.model > 1
        self.shard_spatial = shard_spatial and mesh.model > 1

    # ---- data axis
    def reduce_data(self, x):
        """Sum of x over the data group, differentiable: the backward sums
        the gradients over the group too."""
        if self.mesh.data == 1:
            return x
        return _AllReduceSum.apply(x, self.mesh.data_group)

    def dropout_rows(self, n_local):
        """(global rows, this rank's first row) of a batch whose local
        part has ``n_local`` rows."""
        return n_local * self.mesh.data, n_local * self.mesh.data_rank

    # ---- model axis
    def source_block(self, n_src):
        if not self.shard_views:
            return 0, n_src
        return view_blocks(n_src, self.mesh.model)[self.mesh.model_rank]

    def sum_views(self, xs):
        """Each tensor of xs summed over the model group, in one
        differentiable all_reduce (the tensors share all axes but 1)."""
        if not self.shard_views:
            return xs
        sizes = [x.shape[1] for x in xs]
        y = _AllReduceSum.apply(torch.cat(xs, 1), self.mesh.model_group)
        return torch.split(y, sizes, 1)

    def gather_view_stats(self, xs, n_src, has_ref):
        """Per-view statistics (g_local, C) of the views this rank holds
        ([ref] + its block), each tensor of xs -> (has_ref + n_src, C) of
        every view in order, by a sum of zero-padded blocks (exact, and an
        all_reduce, which both backends take on either device)."""
        if not self.shard_views:
            return xs
        sizes = [x.shape[-1] for x in xs]
        stats = torch.cat(xs, -1)
        start, stop = self.source_block(n_src)
        out = stats.new_zeros((int(has_ref) + n_src,) + stats.shape[1:])
        if has_ref and self.mesh.model_rank == 0:
            out[0] = stats[0]
        out[int(has_ref) + start:int(has_ref) + stop] = stats[int(has_ref):]
        dist.all_reduce(out, group=self.mesh.model_group)
        return torch.split(out, sizes, -1)

    def depth_block(self, D, multiple=1):
        """This rank's [start, stop) of D hypotheses ((0, D) without depth
        sharding); raises ValueError for a split the halos cannot serve
        (``depth_split_error``)."""
        if not self.shard_depth:
            return 0, D
        why = depth_split_error(D, self.mesh.model, multiple)
        if why:
            raise ValueError(why)
        n = D // self.mesh.model
        return n * self.mesh.model_rank, n * (self.mesh.model_rank + 1)

    def depth_slices(self, D, multiple=1):
        """(pre, post): the hypotheses this rank warps, and its block of
        what it warped, kept after the view sums.  Depth alone: this
        rank's block, then all of it; with views: all D of its own views,
        then its block of the summed volume."""
        start, stop = self.depth_block(D, multiple)
        block = slice(start, stop)
        if self.shard_depth and not self.shard_views:
            return block, slice(None)
        return slice(None), block

    def sweep_reduce(self, x, op):
        """x reduced over the model group where this rank warps a block
        of the hypotheses (depth without views), detached; x as it is
        elsewhere."""
        if not (self.shard_depth and not self.shard_views):
            return x
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=op, group=self.mesh.model_group)
        return y

    def gather_depths(self, xs):
        """Each D-block (B, Dl, ...) of xs -> the whole volume (B, D, ...),
        the same on every model rank, in one differentiable all_reduce of
        zero-padded blocks (the tensors share shape and dtype); its
        backward sums the gradients over the group, as ``sum_views``'s
        does."""
        if not self.shard_depth:
            return xs
        x = torch.stack(xs, -1)
        B, Dl, rest = x.shape[0], x.shape[1], x.shape[2:]
        m, M = self.mesh.model_rank, self.mesh.model
        full = torch.cat([x.new_zeros((B, Dl * m) + rest), x,
                          x.new_zeros((B, Dl * (M - 1 - m)) + rest)], 1)
        return torch.unbind(_AllReduceSum.apply(full, self.mesh.model_group),
                            -1)

    def sync_gradients(self, model):
        """Average the gradients over the data group, and those of the
        model-sharded modules (under spatial, with or without the others,
        all: every module runs on a block of rows, views or hypotheses)
        over the model group, one flat bucket each.  Within a group every
        rank computes the same loss (the data group all-reduces the loss's
        sums, the model group the view sums, the D-blocks or the row
        blocks), so the backward of those all_reduces sums the ranks'
        equal gradients: a rank's gradient is the group's size times its
        own share, and the mean over the group is the sum of the shares.
        The replicated rest of the step holds the whole gradient on every
        model rank already."""
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh.data > 1:
            _mean_bucket([p.grad for p in params], self.mesh.data_group,
                         self.mesh.data)
        if self.shard_spatial:
            # every module runs on a block of rows (or, with views or
            # depth, of views or hypotheses): each rank holds M times its
            # share of every gradient
            _mean_bucket([p.grad for p in params], self.mesh.model_group,
                         self.mesh.model)
        elif self.shard_views or self.shard_depth:
            names = DEPTH_SHARDED if self.shard_depth else VIEW_SHARDED
            sharded = [p.grad for name in names
                       for p in getattr(model, name).parameters()]
            _mean_bucket(sharded, self.mesh.model_group, self.mesh.model)


def _mean_bucket(grads, group, n):
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


_tls = threading.local()


def _active() -> Optional[ShardingPolicy]:
    return getattr(_tls, "policy", None)


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    prev = _active()
    _tls.policy = policy
    try:
        yield
    finally:
        _tls.policy = prev


@contextlib.contextmanager
def depth_blocks():
    """Marks a module that runs on this rank's D-block of a volume
    (``CostRegNet``, ``CSPBlock``): under a depth policy its 3-D layers
    take their halos from the neighbouring ranks (``run_blocked``) and
    its train-mode BN sums over the model group."""
    prev = getattr(_tls, "depth", False)
    _tls.depth = True
    try:
        yield
    finally:
        _tls.depth = prev


@contextlib.contextmanager
def image_rows(H):
    """The forward's image of ``H`` rows: under spatial sharding it fixes
    every model rank's block of rows (``row_blocks_of``; ValueError, with
    the reason, for a split that leaves a rank none) for ``row_blocks``,
    ``row_slice`` and ``gather_rows`` inside, and yields this rank's
    [start, stop); (0, H) elsewhere."""
    pol = _active()
    prev = getattr(_tls, "rows", None)
    if pol is None or not pol.shard_spatial:
        yield 0, H
        return
    _tls.rows = row_blocks_of(H, pol.mesh.model)
    try:
        yield _tls.rows[pol.mesh.model_rank]
    finally:
        _tls.rows = prev


@contextlib.contextmanager
def row_blocks(on=True):
    """Marks code that runs on this rank's block of rows of every tensor
    (``on``), or on all rows (``on=False``, the view-sharded part under
    ``views,spatial``): inside ``image_rows`` under spatial sharding,
    its convolutions, the ConvGRU, the stem chain, the fused 3-D layers
    and ``convex_upsample`` take their halos from the neighbouring ranks
    (``run_blocked``) and its train-mode BN sums over the model group."""
    prev = getattr(_tls, "row_blocks", False)
    _tls.row_blocks = on
    try:
        yield
    finally:
        _tls.row_blocks = prev


@contextlib.contextmanager
def view_stats(n_src, has_ref):
    """Marks the BN calls of a view-grouped module (the FPN over [ref] +
    sources, or PixelwiseNet over the sources) so that their running
    statistics gather every view's."""
    prev = getattr(_tls, "views", None)
    _tls.views = (n_src, has_ref)
    try:
        yield
    finally:
        _tls.views = prev


# ---- hooks the model calls: identities without an active policy

def reduce_data(x):
    pol = _active()
    return x if pol is None else pol.reduce_data(x)


def data_parallel() -> int:
    """The number of data ranks of the active policy (1 without one)."""
    pol = _active()
    return 1 if pol is None else pol.mesh.data


def dropout_rows(n_local):
    pol = _active()
    return (n_local, 0) if pol is None else pol.dropout_rows(n_local)


def local_source_views(n_src):
    """[start, stop) of the source views this rank runs."""
    pol = _active()
    return (0, n_src) if pol is None else pol.source_block(n_src)


def sum_views(*xs):
    pol = _active()
    return xs if pol is None else pol.sum_views(xs)


def gather_view_stats(*xs):
    """Inside ``view_stats``: every view's statistics in order."""
    pol = _active()
    views = getattr(_tls, "views", None)
    if pol is None or views is None:
        return xs
    return pol.gather_view_stats(xs, *views)


def _row_split() -> Optional[list]:
    """Every model rank's [start, stop) of the image rows inside
    ``image_rows`` under spatial sharding; None elsewhere."""
    pol = _active()
    if pol is None or not pol.shard_spatial:
        return None
    return getattr(_tls, "rows", None)


def _blocked():
    """The active policy and the axis, ``"depth"`` or ``"rows"``, of the
    block that code inside ``depth_blocks`` under a depth policy or
    ``row_blocks`` under a spatial one runs on, or (None, None).  Raises
    RuntimeError where both are active: no layout splits a tensor along D
    and H at once (under ``depth,spatial`` the volume part runs inside
    ``row_blocks(False)``), and a module there would take halos along
    both axes and count its BN elements twice."""
    pol = _active()
    depth = (pol is not None and pol.shard_depth
             and getattr(_tls, "depth", False))
    rows = _row_split() is not None and getattr(_tls, "row_blocks", False)
    if depth and rows:
        raise RuntimeError(
            "a module runs inside depth_blocks and row_blocks at once: one "
            "tensor split along D and H, which no layout does; run the "
            "volume part inside row_blocks(False)")
    if depth:
        return pol, "depth"
    return (pol, "rows") if rows else (None, None)


def reduce_blocks(x):
    """Inside ``depth_blocks`` or ``row_blocks``: x summed over the model
    group, whose ranks hold the other blocks, differentiable."""
    pol, _ = _blocked()
    return x if pol is None else _AllReduceSum.apply(x, pol.mesh.model_group)


def _global_rows(h_local):
    """The rows of the whole tensor whose block on this rank has
    ``h_local`` rows (inside ``image_rows`` under spatial sharding): every
    level's blocks are the image's scaled by the same power of two."""
    split = _row_split()
    start, stop = split[_active().mesh.model_rank]
    H = split[-1][1]
    if (H * h_local) % (stop - start):
        raise ValueError(f"a block of {h_local} rows is no level of the "
                         f"image's block of {stop - start}")
    return H * h_local // (stop - start)


def _blocks_at(h):
    """Every model rank's [start, stop) of a tensor of ``h`` rows."""
    split = _row_split()
    k, rem = divmod(split[-1][1], h)
    if rem or any(a % k or b % k for a, b in split):
        raise ValueError(f"{h} rows are no level of the image's "
                         f"{split[-1][1]} rows split as {split}")
    return [(a // k, b // k) for a, b in split]


def block_count(n, h_local):
    """The elements of the whole tensor per channel of which this rank's
    block holds ``n`` with ``h_local`` rows: n times the D-blocks inside
    ``depth_blocks``, n scaled from this rank's rows to all rows inside
    ``row_blocks``; n elsewhere."""
    pol, axis = _blocked()
    if axis == "depth":
        return n * pol.mesh.model
    if axis == "rows":
        return n // h_local * _global_rows(h_local)
    return n


def _block_axis(kind, x):
    """The axis of x a block of ``kind`` (``_blocked``) cuts: D of a volume
    (B, D, H, W, C), or the rows of (B, H, W, C) and (B, D, H, W, C); None
    where x is whole."""
    if kind == "depth":
        return 1 if x.dim() == 5 else None
    return None if kind is None else x.dim() - 3


def halo(x, lo, hi):
    """Inside ``depth_blocks`` or ``row_blocks``: the block x with ``lo``
    entries of the block before it (the left D-block, the rank above's
    rows) and ``hi`` of the block after it along the axis they cut, zeros
    past the whole tensor's ends, differentiable (``_Halo``)."""
    pol, kind = _blocked()
    m = pol.mesh
    return _Halo.apply(x, _block_axis(kind, x), lo, hi, m.model_group,
                       m.model_rank, m.model)


def run_blocked(fn, *xs, res=None, **reach):
    """``fn(*xs)`` (with ``res=res`` where given) on the whole tensors, or,
    inside ``depth_blocks`` under a depth policy or ``row_blocks`` under
    a spatial one, on this rank's blocks of them with the halo the op
    reaches (``on_block``; ``reach`` its keywords).  The one place that
    decides where an op runs: without a policy it returns ``fn(*xs)``
    untouched."""
    pol, kind = _blocked()
    axis = _block_axis(kind, xs[0])
    if axis is None:
        return fn(*xs) if res is None else fn(*xs, res=res)
    rank, size = pol.mesh.model_rank, pol.mesh.model
    return on_block(fn, xs, axis, halo, (rank == 0, rank == size - 1),
                    res=res, **reach)


def _per_dim(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


def on_block(fn, xs, axis, exchange, ends, taps=3, stride=1,
             transpose=False, valid=False, clip=False, res=None):
    """``fn`` on the blocks ``xs`` (None skipped; n entries along ``axis``)
    of tensors whose other blocks the neighbouring ranks hold, cropped to
    this block's share of the whole output: each entry from the same
    inputs as on the whole tensor.  The op along the axis: ``taps``
    centred entries at ``stride`` (an int or one a spatial dim each), or
    a ``transpose`` convolution (output padding stride - 1).
    ``exchange(t, lo, hi)`` adds the neighbours' entries, zeros past the
    ends.  ``valid``: fn takes ``unpadded=axis`` and does not pad it.
    Otherwise fn pads itself and only cropped outputs read that padding
    (a stride-s block takes a multiple of s from the left, for parity).
    ``clip`` (stride 1): no halo past the ends (``ends``: first, last
    block), where fn's own padding stands, as K4's and K2's inner layers
    need.  ``res`` (fn's, the output's shape) is zero padded to the
    extended output.  A stride-s block holds a multiple of s entries."""
    x = xs[0]
    k = _per_dim(taps, x.dim() - 2)[axis - 1]
    s = _per_dim(stride, x.dim() - 2)[axis - 1]
    n, p = x.shape[axis], (k - 1) // 2
    pad = 0 if valid else p             # fn's own zero padding
    if transpose:
        lo, hi = (k - 1 - p) // s, (p + s - 1) // s
    elif n % s:
        raise ValueError(f"a stride-{s} op does not map a block of {n} along "
                         f"axis {axis} onto a block")
    else:
        lo, hi = (p if valid else -(-p // s) * s), k - s - p
    first, last = ends if clip else (False, False)
    top, bottom = (0 if first else lo), (0 if last else hi)

    def extend(t):
        if t is None or not (lo or hi):
            return t
        ext = exchange(t, lo, hi)
        return ext.narrow(axis, lo - top, n + top + bottom) if clip else ext
    start = s * top + p - pad if transpose else (top + pad - p) // s
    m = n * s if transpose else n // s
    kw = {"unpadded": axis} if valid else {}
    if res is not None:
        ne = n + top + bottom
        size = ne * s if transpose else (ne - 1) // s + 1
        kw["res"] = torch.nn.functional.pad(
            res, (0, 0) * (res.dim() - 1 - axis) + (start, size - start - m))
    return fn(*map(extend, xs), **kw).narrow(axis, start, m)


def row_slice(h):
    """This rank's rows of a tensor of ``h`` rows inside ``image_rows``
    under spatial sharding (a slice of axis H); all of them elsewhere."""
    if _row_split() is None:
        return slice(None)
    start, stop = _blocks_at(h)[_active().mesh.model_rank]
    return slice(start, stop)


def gather_rows(*xs, axis):
    """Each row block of xs (rows on ``axis``) -> the whole tensor, the
    same on every model rank, in one differentiable all_reduce of
    zero-padded tensors (xs may differ in shape, not in dtype); its
    backward sums the gradients over the group, as ``sum_views``'s does.
    xs as they are without spatial sharding."""
    if _row_split() is None:
        return xs
    pol = _active()
    fulls = []
    for x in xs:
        ax = axis % x.dim()
        blocks = _blocks_at(_global_rows(x.shape[ax]))
        start, stop = blocks[pol.mesh.model_rank]
        shape = tuple(x.shape)
        fulls.append(torch.cat([
            x.new_zeros(_with_axis(shape, ax, start)), x,
            x.new_zeros(_with_axis(shape, ax, blocks[-1][1] - stop))], ax))
    flat = _AllReduceSum.apply(torch.cat([f.reshape(-1) for f in fulls]),
                               pol.mesh.model_group)
    return tuple(y.view(f.shape) for y, f in
                 zip(torch.split(flat, [f.numel() for f in fulls]), fulls))


def depth_slices(D, multiple=1):
    """``ShardingPolicy.depth_slices``; all of D without a policy."""
    pol = _active()
    if pol is None:
        return slice(None), slice(None)
    return pol.depth_slices(D, multiple)


def depth_sharded() -> bool:
    """Whether the active policy splits the cost volumes by hypotheses."""
    pol = _active()
    return pol is not None and pol.shard_depth


def sweep_max(x):
    """x's max over the model group where this rank warps a block of the
    hypotheses, detached; x elsewhere."""
    pol = _active()
    return x if pol is None else pol.sweep_reduce(x, dist.ReduceOp.MAX)


def sweep_sum(x):
    """x's sum over the model group where this rank warps a block of the
    hypotheses, detached; x elsewhere."""
    pol = _active()
    return x if pol is None else pol.sweep_reduce(x, dist.ReduceOp.SUM)


def gather_depths(*xs):
    """The whole volumes of D-blocks; xs without depth sharding."""
    pol = _active()
    return xs if pol is None else pol.gather_depths(xs)
