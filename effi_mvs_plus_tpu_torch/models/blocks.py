"""Network blocks: FPN feature/context net, pixel-wise view-weight net,
3-D cost regulariser, cross-scale propagation block, ConvGRU update block.

Port of the XLA branch of ``effi_mvs_plus_tpu/models/blocks.py``.  Every
block is an ``nn.Module`` whose parameter names are the reference
state-dict names, so the shipped checkpoints load strictly.  Tensors are
channels-last, as in the JAX package.  ``train()`` switches BN to batch
statistics and turns on the update block's two channel dropouts (p=0.1).
``CostRegNet`` and ``CSPBlock`` run inside ``parallel.depth_blocks``:
under a depth policy their inputs are this rank's D-block of the volume
and their 3-D layers exchange halos along D.  Inside
``parallel.row_blocks`` under a spatial policy every block's input is
this rank's block of image rows.  Every convolution, the ConvGRU's
kernel, the stem chain and the fused 3-D layers run on the block with
the halo they reach and are cropped (``parallel.run_blocked``: each
states only its taps and stride).  Without a policy nothing changes.
"""

from __future__ import annotations

import torch
from torch import nn as tnn

from effi_mvs_plus_tpu_torch import nn
from effi_mvs_plus_tpu_torch.ops import cuda_conv, cuda_conv3d, cuda_gru
from effi_mvs_plus_tpu_torch.parallel import mesh as par
from effi_mvs_plus_tpu_torch.utils.profiling import span


def _upsample_nearest2x(x):
    """(B,H,W,C) -> (B,2H,2W,C), nearest."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def stem_chain_applies(x, training):
    """Whether ``FeatureNet`` runs its stride-1 3x3 runs through the stem
    chain K4: where K4 is a kernel (a CUDA tensor) and can run, that is in
    eval mode with grad off (it folds running-statistic BN and has no
    backward).  On the CPU the blocks run one by one, as the JAX package's
    default stem (``stem_impl='xla'``) does, so the CPU keeps its
    arithmetic: a bf16 forward fused there moves the noise-image depth
    maps past tests/test_torch_bf16.py's bound against JAX."""
    return x.is_cuda and not (training or torch.is_grad_enabled())


def reg_applies(x, training):
    """Whether ``CostRegNet`` and ``CSPBlock`` run their 3-D layers through
    ``cuda_conv3d.conv3d_reg``, a fused launch a layer: where the stem
    chain runs (a CUDA tensor, eval mode, grad off), on the whole volume
    or on a block of it (a depth or a spatial policy, ``_reg_layer``)."""
    return stem_chain_applies(x, training)


def _reg_layer(x, layer, x2=None, res=None):
    """``cuda_conv3d.conv3d_reg`` of one layer, on this rank's block with
    its halo where a policy blocks the volume (``parallel.run_blocked``)."""
    return par.run_blocked(
        lambda x, x2, res=None: cuda_conv3d.conv3d_reg(x, layer, x2, res),
        x, x2, stride=layer.stride, transpose=layer.transpose, res=res)


def freeze_kernel_weights(model):
    """Declare ``model``'s weights final (the ``InferenceEngine``'s): each
    ConvGRU and FPN then folds and packs its kernel's operands once per
    dtype, at its first forward, and hands them to every later kernel call
    instead of packing at each launch.  Parameters stop requiring grad.  A
    weight changed or moved afterwards is not seen: build a new model."""
    for m in model.modules():
        if isinstance(m, (ConvGRU, FeatureNet)):
            m.frozen = {}
    return model.requires_grad_(False)


def _frozen(module, key, build):
    """``build()`` made once per ``key`` where the module's weights are
    frozen (``freeze_kernel_weights``); None where they are not."""
    if module.frozen is None:
        return None
    if key not in module.frozen:
        module.frozen[key] = build()
    return module.frozen[key]


def _level(cin, cout, first_k, first_stride, n):
    """One FPN level: a k x k conv (stride `first_stride`) then n-1 3x3
    convs, each conv + BN + ReLU."""
    return tnn.ModuleList(
        [nn.ConvBlock(2, cin, cout, first_k, first_stride, first_k // 2)]
        + [nn.ConvBlock(2, cout, cout) for _ in range(n - 1)])


class FeatureNet(tnn.Module):
    """4-level conv pyramid + top-down FPN (feature_net).  x: (B,H,W,3).
    Returns {'stage1': 1/8-res, 'stage2': 1/4-res, 'stage3': 1/2-res}.
    ``stat_groups``: train-mode BN statistics per group of the batch
    axis (``nn.batch_norm``).

    Where ``stem_chain_applies`` (on the card, eval mode, grad off), each
    level's run of stride-1 3x3 conv + BN + ReLU blocks (conv0's two, and
    the two after conv1-3's 5x5 stride-2 block) runs as one
    ``cuda_conv.conv_bn_relu_chain`` with BN folded in its
    running-statistic form; elsewhere the blocks run one by one."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.frozen = None
        self.conv0 = _level(3, in_ch[0], 3, 1, 2)
        self.conv1 = _level(in_ch[0], in_ch[1], 5, 2, 3)
        self.conv2 = _level(in_ch[1], in_ch[2], 5, 2, 3)
        self.conv3 = _level(in_ch[2], in_ch[3], 5, 2, 3)
        self.out1 = nn.Conv(2, in_ch[3], out_ch[0], 1, bias=False)
        self.inner1 = nn.Conv(2, in_ch[2], in_ch[3], 1)
        self.inner2 = nn.Conv(2, in_ch[1], in_ch[3], 1)
        self.out2 = nn.Conv(2, in_ch[3], out_ch[1], 3, padding=1, bias=False)
        self.out3 = nn.Conv(2, in_ch[3], out_ch[2], 3, padding=1, bias=False)

    def _run_level(self, i, x, stat_groups, fused):
        level = getattr(self, f"conv{i}")
        if not fused:
            for blk in level:
                x = blk(x, stat_groups)
            return x
        blocks = list(level)
        if blocks[0].conv.stride != 1:
            x = blocks.pop(0)(x)

        def fold():
            return [cuda_conv.fold_bn(b.conv.weight, b.bn) for b in blocks]

        def fold_and_pack():
            specs = fold()
            return specs, cuda_conv.pack(specs, x.dtype)
        specs, packed = (_frozen(self, (i, x.dtype), fold_and_pack)
                         or (fold(), None))
        # on a row block the chain reaches one row a layer, its own zero
        # padding at the image's edges
        return par.run_blocked(
            lambda t: cuda_conv.conv_bn_relu_chain(t.contiguous(), specs,
                                                   packed),
            x, taps=2 * len(specs) + 1, clip=True)

    def forward(self, x, stat_groups=1):
        fused = stem_chain_applies(x, self.training)
        conv1 = self._run_level(
            1, self._run_level(0, x, stat_groups, fused), stat_groups, fused)
        conv2 = self._run_level(2, conv1, stat_groups, fused)
        intra = self._run_level(3, conv2, stat_groups, fused)
        out = {"stage1": self.out1(intra)}
        intra = _upsample_nearest2x(intra) + self.inner1(conv2)
        out["stage2"] = self.out2(intra)
        intra = _upsample_nearest2x(intra) + self.inner2(conv1)
        out["stage3"] = self.out3(intra)
        return out


class PixelwiseNet(tnn.ModuleList):
    """Entropy map (B,H,W,1) -> per-view weight (B,H,W,1) in (0,1);
    ``stat_groups`` as for ``FeatureNet``."""

    def __init__(self):
        super().__init__([nn.ConvBlock(2, 1, 16), nn.ConvBlock(2, 16, 16),
                          nn.ConvBlock(2, 16, 8), nn.Conv(2, 8, 1, 1)])

    def forward(self, x, stat_groups=1):
        *blocks, head = self
        for blk in blocks:
            x = blk(x, stat_groups)
        return nn.sigmoid(head(x))


class CostRegNet(tnn.Module):
    """3-level 3-D U-Net.  x: (B,D,H,W,G) -> (prob_pre (B,D,H,W),
    pro (B,D,H,W,8)).  D, H, W must be divisible by 4, and so must a
    D-block (``DEPTH_MULTIPLE``): two stride-2 layers halve D.  Where
    ``reg_applies`` each of its 9 layers, with its BN, ReLU and residual,
    is one ``cuda_conv3d.conv3d_reg`` (on a D-block or a row block with
    its halo: ``_reg_layer``); elsewhere the blocks run one by one."""

    DEPTH_MULTIPLE = 4
    LAYERS = ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6",
              "conv7", "prob")

    def __init__(self, G=1):
        super().__init__()
        chans = [(G, 8), (8, 8), (8, 16), (16, 16), (16, 32), (32, 32)]
        for i, (ci, co) in enumerate(chans):
            setattr(self, f"conv{i}", nn.ConvBlock(
                3, ci, co, stride=2 if i in (2, 4) else 1))
        self.conv6 = nn.ConvBlock(3, 32, 16, stride=2, transpose=True,
                                  output_padding=1)
        self.conv7 = nn.ConvBlock(3, 16, 8, stride=2, transpose=True,
                                  output_padding=1)
        self.prob = nn.Conv(3, 8, 1, 3, padding=1, bias=False)

    def _fused(self, x):
        c0, c1, c2, c3, c4, c5, c6, c7, prob = (
            cuda_conv3d.layer(getattr(self, n)) for n in self.LAYERS)
        run = _reg_layer
        conv1 = run(run(x.contiguous(), c0), c1)
        conv3 = run(run(conv1, c2), c3)
        up = run(run(run(conv3, c4), c5), c6, res=conv3)
        pro = run(up, c7, res=conv1)
        return run(pro, prob)[..., 0], pro

    def forward(self, x):
        with par.depth_blocks():
            if reg_applies(x, self.training):
                return self._fused(x)
            conv1 = self.conv1(self.conv0(x))
            conv3 = self.conv3(self.conv2(conv1))
            mid = self.conv5(self.conv4(conv3))
            up = conv3 + self.conv6(mid)
            pro = conv1 + self.conv7(up)
            return self.prob(pro)[..., 0], pro


class CSPBlock(tnn.Module):
    """Cross-scale propagation: fuse the resampled half-resolution
    previous-stage volume (B,D,H/2,W/2,1) into the fresh volume
    (B,D,H,W,G).  Returns (B,D,H,W).  Where ``reg_applies`` each of its 4
    layers is one ``cuda_conv3d.conv3d_reg``, ``conv1`` reading ``down``
    and ``emb`` as one input without their concatenation."""

    LAYERS = ("conv0", "conv_cost", "conv1", "conv2")

    def __init__(self, G=1):
        super().__init__()
        self.conv0 = nn.ConvBlock(3, G, 8, stride=(1, 2, 2))
        self.conv_cost = nn.ConvBlock(3, 1, 8)
        self.conv1 = nn.ConvBlock(3, 16, 8)
        self.conv2 = nn.ConvBlock(3, 8, 1, stride=(1, 2, 2), transpose=True,
                                  output_padding=(0, 1, 1))

    def forward(self, cur_volume, prev_volume):
        with par.depth_blocks():
            if reg_applies(cur_volume, self.training):
                c0, cost, c1, c2 = (cuda_conv3d.layer(getattr(self, n))
                                    for n in self.LAYERS)
                run = _reg_layer
                down = run(cur_volume.contiguous(), c0)
                emb = run(prev_volume.contiguous(), cost)
                return run(run(down, c1, x2=emb), c2)[..., 0]
            down = self.conv0(cur_volume)
            emb = self.conv_cost(prev_volume)
            fused = self.conv1(torch.cat([down, emb], dim=-1))
            return self.conv2(fused)[..., 0]


class ProjectionInput(tnn.Module):
    """Motion encoder: fuse inverse depth (B,H,W,1), cost lookup
    (B,H,W,cost_dim) and context (B,H,W,cdim) -> (B,H,W,hdim)."""

    def __init__(self, hdim, cdim, cost_dim):
        super().__init__()
        self.convc1 = nn.Conv(2, cost_dim, hdim, 1)
        self.convc2 = nn.Conv(2, hdim, hdim, 3, padding=1)
        self.convd1 = nn.Conv(2, 1, hdim, 7, padding=3)
        self.convd2 = nn.Conv(2, hdim, hdim, 3, padding=1)
        self.convd = nn.Conv(2, 2 * hdim, hdim - cdim, 3, padding=1)
        self.convc = nn.Conv(2, hdim, hdim, 1)
        self.dropout = nn.ChannelDropout(0.1)

    def forward(self, disp, cost, context):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(cost))))
        dfm = torch.relu(self.convd2(torch.relu(self.convd1(disp))))
        y = self.convd(torch.cat([cor, dfm], dim=-1))
        return self.dropout(
            torch.relu(self.convc(torch.cat([y, context], dim=-1))))


class ConvGRU(tnn.Module):
    """ConvGRU with 3x3 gates (h and x each hdim wide)."""

    def __init__(self, hdim, xdim):
        super().__init__()
        self.frozen = None
        self.convz = nn.Conv(2, hdim + xdim, hdim, 3, padding=1)
        self.convr = nn.Conv(2, hdim + xdim, hdim, 3, padding=1)
        self.convq = nn.Conv(2, hdim + xdim, hdim, 3, padding=1)

    def forward(self, h, x):
        packed = _frozen(self, h.dtype, lambda: cuda_gru.pack(self, h.dtype))
        # q's 3x3 convolution of r*h reaches one row past r, and r one row
        # of [h, x] past that: two rows, the kernel's own zero padding at
        # the image's edges
        return par.run_blocked(
            lambda h, x: cuda_gru.gru_step(h.contiguous(), x.contiguous(),
                                           self, packed),
            h, x, taps=5, clip=True)


class DepthHead(tnn.Module):
    """hidden -> tanh-bounded inverse-depth delta (B,H,W,1)."""

    def __init__(self, hdim):
        super().__init__()
        self.conv1 = nn.Conv(2, hdim, hdim, 3, padding=1)
        self.conv2 = nn.Conv(2, hdim, 1, 3, padding=1)
        self.dropout = nn.ChannelDropout(0.1)

    def forward(self, h):
        return torch.tanh(self.dropout(self.conv2(torch.relu(self.conv1(h)))))


class UpdateBlock(tnn.Module):
    """RAFT-style iterative refinement (update_block)."""

    def __init__(self, hdim, cdim, cost_dim, ratio):
        super().__init__()
        self.encoder = ProjectionInput(hdim, cdim, cost_dim)
        self.depth_gru = ConvGRU(hdim, hdim)
        self.depth_head = DepthHead(hdim)
        self.mask = tnn.Sequential(
            nn.Conv(2, hdim, 2 * hdim, 3, padding=1), tnn.ReLU(),
            nn.Conv(2, 2 * hdim, 9 * ratio * ratio, 1))

    def upsample_mask(self, h):
        """hidden -> convex-upsampling mask logits, scaled 0.25."""
        return 0.25 * self.mask(h)

    def forward(self, hidden, get_cost, inv_depth, context, seq_len,
                scale_inv_depth):
        """hidden (B,H,W,hdim); inv_depth (B,H,W,1) normalised inverse
        depth; ``get_cost(depth)`` resamples the stored volumes around
        ``depth``.  Returns (hidden, mask_logits, [inv_depth per iter]).
        The iterate is detached at the top of every iteration, as in the
        reference: no gradient flows from one iteration's depth into the
        next one's cost lookup and encoder.

        The inverse-depth iterate and its deltas accumulate in fp32
        whatever the compute dtype: a bf16 carry quantises the estimate to
        about 0.4% and the refinement diverges instead of converging.
        Only the conv inputs are cast down.
        """
        cdt = context.dtype
        inv_depth = inv_depth.float()
        inv_depths = []
        for _ in range(seq_len):
            with span("model.gru_iter"):
                inv_depth = inv_depth.detach()
                depth = scale_inv_depth(inv_depth)[1]
                cost = get_cost(depth)
                x = self.encoder(inv_depth.to(cdt), cost, context)
                hidden = self.depth_gru(hidden, x)
                delta = self.depth_head(hidden)
                inv_depth = inv_depth + delta.float()
                inv_depths.append(inv_depth)
        return hidden, self.upsample_mask(hidden), inv_depths
