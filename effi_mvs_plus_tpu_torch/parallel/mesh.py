"""Data and source-view parallelism over a (data, model) grid of ranks.

The port of ``effi_mvs_plus_tpu/parallel/mesh.py``.  Rank ``r`` sits at
(data ``r // model``, model ``r % model``), and each axis has its own
process group.

* ``data``  — each data rank takes its rows of the global batch.  The
  step still computes what the whole batch computes: train-mode BN
  all-reduces its sums over the data group (``reduce_data``), the loss
  its masked sums, the dropout masks are drawn for the global batch and
  each rank keeps its rows (``dropout_rows``), and the gradients are
  averaged over the group before the optimizer (``sync_gradients``).
* ``model`` — each model rank runs the FPN and the
  per-view warps and ``PixelwiseNet`` on its contiguous block of the
  source views (``local_source_views``; every rank also runs the
  reference view), and the view-weighted sums are all-reduced over the
  group (``sum_views``).  Per-view BN statistics stay with the views a
  rank holds; the running statistics gather every view's, in order
  (``gather_view_stats``).  The rest of the network runs replicated.

The model calls the module-level hooks, which do nothing unless a
``ShardingPolicy`` is active (``use_policy``), so a single process pays
nothing.  The JAX package's ``depth`` and ``spatial`` layouts are refused
(``layout_kinds``; ROADMAP A11b and A11).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist

from effi_mvs_plus_tpu_torch.parallel import distributed as D

# the modules that run on a rank's own source views; the rest of the
# network runs replicated on every model rank
VIEW_SHARDED = ("feature", "PixelwiseNet")


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


# the JAX package's other model-axis layouts, and why the port has none
REFUSED_LAYOUTS = {
    "depth": "depth sharding of the cost volume is not ported: it needs "
             "halo exchanges along D through the 3-D U-Net, which GSPMD "
             "inserted for the JAX package (ROADMAP A11b); use views",
    "spatial": "spatial (image-row) sharding is not ported: it was "
               "measured 8x worse per device than unsharded "
               "(SHARDING_TANK_r02.json; ROADMAP A11); use views",
}


def layout_kinds(spec):
    """The model-axis layouts of a comma list such as ``"views"``;
    raises ValueError, with the reason, for one the port refuses and for
    an empty list (a model axis that shards nothing would only repeat
    the work on every rank)."""
    kinds = {k.strip() for k in spec.split(",") if k.strip()}
    if not kinds:
        raise ValueError("no model-axis layout given; the port has views")
    for k in sorted(kinds):
        if k in REFUSED_LAYOUTS:
            raise ValueError(REFUSED_LAYOUTS[k])
        if k != "views":
            raise ValueError(f"unknown layout {k!r}; the port has views")
    return kinds


class ShardingPolicy:
    """The layouts the model hooks apply on a mesh: the batch over the
    data axis, the source views over the model axis (``shard_views``,
    the one model-axis layout the port has)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.shard_views = mesh.model > 1

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

    def sync_gradients(self, model):
        """Average the gradients over the data group, and those of the
        view-sharded modules over the model group, one flat bucket each.
        Within a group every rank computes the same loss (the data group
        all-reduces the loss's sums, the model group the view sums), so
        the backward of those all_reduces sums the ranks' equal gradients:
        a rank's gradient is the group's size times its own share, and
        the mean over the group is the sum of the shares.  The replicated
        rest of a view-sharded step holds the whole gradient on every
        model rank already."""
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh.data > 1:
            _mean_bucket([p.grad for p in params], self.mesh.data_group,
                         self.mesh.data)
        if self.shard_views:
            sharded = [p.grad for name in VIEW_SHARDED
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
