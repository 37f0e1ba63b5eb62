"""Effi-MVS+ cascaded coarse-to-fine multi-view depth.

Port of ``effi_mvs_plus_tpu/models/effi_mvs.py``:

stage 1  full inverse-depth plane sweep (D=48) -> pixel-wise view weights
         -> 3-D U-Net regularisation -> expectation depth + confidence;
stages 2/3  fresh 8-hypothesis dynamic cost volume around the current
         depth + cross-scale propagation (CSP) of both stored volumes;
         every stage then runs 3 ConvGRU refinement iterations whose cost
         lookups resample the stored volumes along the depth axis,
         followed by learned convex x2 upsampling.

Outputs 13 depth maps (1 init + 3 stages x (3 iters + upsample)) and a
photometric confidence at half input resolution.

Data contract (channels-last, as in the JAX package):
    imgs:          (B, V, H, W, 3)  float in [0,1]
    proj_matrices: {'stage1'..'stage3': (B, V, 2, 4, 4)}  slot 0
                   extrinsics, slot 1 intrinsics (rows 0-1 pre-scaled)
    depth_values:  (B, Nd) ascending inverse-depth samples

The two kernels of the path, the warp + correlation and the ConvGRU step,
dispatch by the tensors' device (``ops/cuda_warp.py``,
``ops/cuda_gru.py``); there is no implementation switch.  Both are
differentiable: on the card the warp's backward is the kernel K3 and the
GRU's backward recomputes through the plain math.  On the card at
inference (eval mode, grad off) the FPN's stride-1 3x3 runs go through
the stem chain K4 (``ops/cuda_conv.py``) with BN folded
(``blocks.stem_chain_applies``); training and the CPU run those
convolutions one by one.

Training (``model.train()``): BN takes batch statistics per view in the
feature net and per source view in PixelwiseNet (``stat_groups``), the
update blocks apply channel dropout, and the forward detaches where the
reference does — the stage-1 entropy input, the current depth of stages
2-3 and the GRU iterate.

Under a view-sharding policy (``parallel/mesh.py``) each model rank runs
the FPN on the reference and its block of source views, the warps and
``PixelwiseNet`` on that block, and all-reduces the view-weighted sums
``sim_sum`` and ``w_sum``.  Under a depth-sharding policy each model rank
holds a block of every stage's hypotheses (``par.depth_slices``): alone,
it warps that block of every view (the stage-1 entropy takes its max and
sums over D from the group); with views, it keeps its block of the
summed volume.  ``CostRegNet`` and the CSP blocks run on the block, and
their outputs, with the stage-1 similarity, are gathered along D
(``par.gather_depths``).  The rest runs replicated.  Under a spatial
policy each model rank runs every module on its block of image rows
(``par.image_rows``, ``par.row_blocks``): the FPN and the context net
on its rows of the images, the warps on its rows of the reference
against the whole source features (gathered along H, ``par.gather_rows``;
the kernels take the block's first row ``y0``), ``PixelwiseNet``,
``CostRegNet``, the CSP and update blocks with row halos; the 13 depth
maps and the confidence are gathered along H at the end.  Where another
layout shares the model axis with spatial, the part it splits runs over
all rows and each rank keeps its rows of what that part gives: with
views (``views,spatial``) the FPN, the warps and ``PixelwiseNet`` run
this rank's views; with depth (``depth,spatial``) the warps run this
rank's D-block against reference and source features gathered along H,
and ``CostRegNet`` and the CSP blocks the D-block of the volumes
(``par.row_blocks(False)``); ``PixelwiseNet`` then takes its rows of the
entropy and its view weights are gathered along H.  Both at once
(``views,depth,spatial``): the views for the FPN, the warps and
``PixelwiseNet``, D for the summed volumes, the rows for the GRU.
Without a policy the hooks are identities.

Spans (``utils/profiling.py``): ``model.features`` (the FPN and the
context net) and ``model.stage1`` to ``model.stage3``, each with the
device's time under tracing; each GRU iteration is ``model.gru_iter``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn as tnn

from effi_mvs_plus_tpu_torch.core import geometry
from effi_mvs_plus_tpu_torch.models import blocks
from effi_mvs_plus_tpu_torch.ops import (
    convex_upsample, cuda_warp, depth_regression, photometric_confidence,
    resample_volume_at_depths)
from effi_mvs_plus_tpu_torch.parallel import mesh as par
from effi_mvs_plus_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class EffiMVSConfig:
    """Architecture hyper-parameters (the deployed values)."""
    ndepths: Tuple[int, ...] = (48, 8, 8)
    depth_intervals_ratio: Tuple[float, ...] = (4.0, 2.0, 1.0)
    cost_num: int = 2            # stored volumes concatenated per lookup
    CostNum: int = 3             # hypotheses per GRU cost lookup
    gru_iters: Tuple[int, ...] = (3, 3, 3)
    hdim_stage: Tuple[int, ...] = (48, 32, 16)
    cdim_stage: Tuple[int, ...] = (12, 8, 4)
    context_feature: Tuple[int, ...] = (60, 40, 20)
    cost_dim_stage: Tuple[int, ...] = (32, 16, 8)
    feature_in_channel: Tuple[int, ...] = (8, 16, 32, 64)
    context_in_channel: Tuple[int, ...] = (4, 8, 16, 32)
    G: int = 1                   # correlation groups (the kernel takes 1)
    feat_ratio: Tuple[int, ...] = (2, 2, 2)
    num_stage: int = 3
    compute_dtype: torch.dtype = torch.float32   # or torch.bfloat16


# the spans of the forward's stages (``utils/profiling.py``)
_STAGE_SPANS = ("model.stage1", "model.stage2", "model.stage3")


def _bshape(x, ndim):
    """Per-batch scalars (B,) -> rank `ndim` for broadcasting."""
    return x.reshape(x.shape[0], *([1] * (ndim - 1)))


def _repeat2x_hw(x, h_axis, w_axis):
    return x.repeat_interleave(2, dim=h_axis).repeat_interleave(2, dim=w_axis)


def _relative_projections(P):
    """(B, V, 4, 4) composed projections -> per-src-view (rot, trans)
    mapping ref rays to src pixels: (B, V-1, 3, 3), (B, V-1, 3)."""
    Pv = P[:, 1:]
    return geometry.relative_projection(Pv, P[:, 0:1].expand_as(Pv))


def stage_depth_multiple(s):
    """The multiple of planes a D-block of stage s (0-based) must hold:
    stage 1's volume passes CostRegNet's two stride-2 layers along D, the
    later stages' only the CSP blocks' stride-1 ones."""
    return blocks.CostRegNet.DEPTH_MULTIPLE if s == 0 else 1


def _sweep_entropy(sims):
    """Entropy over D of each view's softmax-normalised correlations,
    detached: (B,V,D,h,w) -> (B,V,h,w).  ``nn.softmax``'s steps, with the
    max and the sums over D taken over the model group where this rank
    warps a block of the hypotheses (``par.sweep_max``/``sweep_sum``).
    In bf16 mode it runs on the bf16 correlations."""
    x = sims.detach()
    u = torch.exp(x - par.sweep_max(x.amax(2, keepdim=True)))
    pnorm = u / par.sweep_sum(u.float().sum(2, keepdim=True)).to(x.dtype)
    return -par.sweep_sum(torch.sum(pnorm * torch.log(pnorm + 1e-7), dim=2))


class EffiMVS(tnn.Module):
    """The network.  Parameter names are the reference state-dict names;
    the reference registers the update blocks and CSP blocks a second
    time in ModuleLists (``update_block``, ``CSP_R``, ``CSP_C``), and the
    same aliases exist here so the shipped 563-key state dict loads
    strictly."""

    def __init__(self, cfg: EffiMVSConfig = EffiMVSConfig()):
        super().__init__()
        if cfg.G != 1:
            raise ValueError("only G=1 correlation is supported")
        self.cfg = cfg
        self.PixelwiseNet = blocks.PixelwiseNet()
        self.feature = blocks.FeatureNet(cfg.feature_in_channel,
                                         cfg.cost_dim_stage)
        self.cnet_depth = blocks.FeatureNet(cfg.context_in_channel,
                                            cfg.context_feature)
        self.cost_regularization = blocks.CostRegNet(cfg.G)
        for name in ("CSP_R1", "CSP_R2", "CSP_C1", "CSP_C2"):
            setattr(self, name, blocks.CSPBlock(cfg.G))
        cost_dim = cfg.G * cfg.CostNum * cfg.cost_num
        for s in range(cfg.num_stage):
            setattr(self, f"update_block_depth{s + 1}", blocks.UpdateBlock(
                cfg.hdim_stage[s], cfg.cdim_stage[s], cost_dim,
                cfg.feat_ratio[s]))
        self.update_block = tnn.ModuleList(
            [getattr(self, f"update_block_depth{s + 1}")
             for s in range(cfg.num_stage)])
        self.CSP_R = tnn.ModuleList([self.CSP_R1, self.CSP_R2])
        self.CSP_C = tnn.ModuleList([self.CSP_C1, self.CSP_C2])

    def forward(self, imgs, proj_matrices, depth_values):
        """Full multi-stage forward pass.

        Returns {'depth': [13 x (B,h,w)] coarsest->finest actual depths
        (fp32), 'photometric_confidence': (B, H/2, W/2)}.
        """
        with par.image_rows(imgs.shape[2]), par.row_blocks():
            depths, conf = self._forward(imgs, proj_matrices, depth_values)
            *depths, conf = par.gather_rows(*depths, conf, axis=1)
        return {"depth": depths, "photometric_confidence": conf}

    def _forward(self, imgs, proj_matrices, depth_values):
        """The forward on this rank's rows (all of them without spatial
        sharding): (13 depth maps, confidence)."""
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        dt = cfg.compute_dtype
        imgs = imgs.to(dt)
        depth_values = depth_values.float()

        disp_min = depth_values[:, 0]
        disp_max = depth_values[:, -1]
        depth_max_g = 1.0 / disp_min          # (B,)
        depth_min_g = 1.0 / disp_max
        depth_interval = (disp_max - disp_min) / depth_values.shape[1]

        def scale_inv_depth(disp):
            return geometry.disp_to_depth(disp,
                                          _bshape(depth_min_g, disp.dim()),
                                          _bshape(depth_max_g, disp.dim()))

        # the source views this rank runs: all of them unless the views
        # are sharded, then a block [start, stop) and the reference
        start, stop = par.local_source_views(V - 1)

        def own_views(x):
            if (start, stop) == (0, V - 1):
                return x
            return torch.cat([x[:, :1], x[:, 1 + start:1 + stop]], 1)
        imgs_own = own_views(imgs)
        Vo = imgs_own.shape[1]
        # under spatial sharding the 2-D part runs on this rank's rows, and
        # the part another layout splits over all rows: with views, the
        # FPN, the warps and PixelwiseNet; with depth, the warps and the
        # 3-D part.  With depth alone the warps' inputs come from the FPN
        # on rows and are gathered along H (``gather_in``); with views
        # alone the 3-D part takes its rows of the warps' output
        # (``rows_out``).  ``keep`` takes this rank's rows of a tensor of
        # all rows where ``on`` (all of them without spatial sharding)
        views_all = (start, stop) != (0, V - 1)
        depth_all = par.depth_sharded()
        warp_all = views_all or depth_all
        gather_in = depth_all and not views_all
        rows_out = views_all and not depth_all
        rows = par.row_slice(H)
        if not views_all:
            imgs_own = imgs_own[:, :, rows]

        def keep(x, axis, on):
            if not on:
                return x
            sl = [slice(None)] * x.dim()
            sl[axis] = par.row_slice(x.shape[axis])
            return x[tuple(sl)]

        def gru_rows(x):
            """A volume (or its per-pixel range) on the 3-D part's rows ->
            this rank's rows; per-batch scalars as they are."""
            return keep(x, 2, depth_all and x.shape[2] > 1)

        with span("model.features", imgs.device):
            # feature extraction: the views through the FPN in one batch, with
            # per-view BN statistics in train mode
            with par.view_stats(V - 1, has_ref=True), \
                    par.row_blocks(not views_all):
                feats = self.feature(
                    imgs_own.reshape(B * Vo, *imgs_own.shape[2:]),
                    stat_groups=Vo)
            feats = {k: v.reshape(B, Vo, *v.shape[1:])
                     for k, v in feats.items()}
            cnet = self.cnet_depth(imgs[:, 0, rows])

            hiddens, contexts = [], []
            for s in range(cfg.num_stage):
                h, inp = torch.split(cnet[f"stage{s + 1}"],
                                     [cfg.hdim_stage[s],
                                      cnet[f"stage{s + 1}"].shape[-1]
                                      - cfg.hdim_stage[s]], dim=-1)
                hiddens.append(torch.tanh(h))
                contexts.append(torch.relu(inp))

        depth_predictions = []
        view_weights = None
        photometric_confidence_map = None
        reg_volume = cur_volume = None        # stored volumes, (B, D, h, w)
        vol_dmin = vol_dmax = None            # their per-pixel depth ranges

        for s in range(cfg.num_stage):
            with span(_STAGE_SPANS[s], imgs.device):
                f = feats[f"stage{s + 1}"]                       # (B,Vo,h,w,C)
                P = geometry.compose_projection(                 # (B,Vo,4,4)
                    own_views(proj_matrices[f"stage{s + 1}"]).float())
                interval_s = depth_interval * cfg.depth_intervals_ratio[s]
                rots, trs = _relative_projections(P)
                # the warps: ref rows y0 .. y0 + h - 1 against the whole source
                # features (under spatial sharding, gathered along H; where the
                # warps run over all rows, the reference too)
                ref_fea, src = f[:, 0], f[:, 1:]
                y0 = 0
                if gather_in:
                    ref_fea, src = par.gather_rows(ref_fea, src, axis=-3)
                elif not views_all:
                    (src,) = par.gather_rows(src, axis=2)
                    y0 = par.row_slice(src.shape[2]).start or 0
                h, w = ref_fea.shape[1], ref_fea.shape[2]

                def warp(depth, ref_fea=ref_fea, src=src, rots=rots, trs=trs,
                         y0=y0):
                    return cuda_warp.warp_correlate_views(
                        ref_fea, src, rots, trs, depth, y0)

                # the hypotheses this rank warps, and its block of them kept
                # after the view sums (all of them without depth sharding)
                pre, post = par.depth_slices(cfg.ndepths[s],
                                             stage_depth_multiple(s))
                if s == 0:
                    # ----- initial full sweep -----
                    # the per-batch sweep stays an expanded (B,D,h,w) view
                    drs = geometry.depth_range_samples_global(
                        depth_values, cfg.ndepths[0], 1, 1)
                    depth_hyps = (1.0 / drs).expand(B, cfg.ndepths[0], h, w)
                    sims = warp(depth_hyps[:, pre])          # (B,Vo-1,D,h,w)
                    # PixelwiseNet on this rank's rows of the entropy, unless
                    # the views run over all rows; its view weights gathered
                    # for the warps' rows
                    entropy = keep(_sweep_entropy(sims), 2, gather_in)
                    with par.view_stats(V - 1, has_ref=False), \
                            par.row_blocks(not views_all):
                        vw = self.PixelwiseNet(
                            entropy.reshape(B * (Vo - 1), *entropy.shape[2:],
                                            1).to(dt),
                            stat_groups=Vo - 1)
                    view_weights = vw.reshape(B, Vo - 1, *entropy.shape[2:])
                    if gather_in:
                        (view_weights,) = par.gather_rows(view_weights, axis=2)
                    vw_ = view_weights[:, :, None]           # (B,Vo-1,1,h,w)
                    sim_sum, w_sum = par.sum_views(
                        torch.sum(sims * vw_, dim=1),            # (B,D,h,w)
                        torch.sum(vw_, dim=1))                   # (B,1,h,w)
                    # the 3-D part: on this rank's rows, or on all rows where
                    # depth splits it
                    similarity = keep(sim_sum / (w_sum + 1e-6), 2,
                                      rows_out)[:, post][..., None]

                    with par.row_blocks(not depth_all):
                        prob_pre, _ = self.cost_regularization(
                            similarity.to(dt))
                    reg_volume, cur_volume = par.gather_depths(
                        prob_pre.float(), similarity[..., 0].float())
                    prob = torch.softmax(gru_rows(reg_volume), dim=1)
                    init_depth = depth_regression(
                        prob, keep(depth_hyps, 2, warp_all))
                    conf = photometric_confidence(prob)
                    photometric_confidence_map = _repeat2x_hw(
                        _repeat2x_hw(conf, 1, 2), 1, 2)          # x4 nearest

                    vol_dmin = _bshape(depth_min_g, 4)
                    vol_dmax = _bshape(depth_max_g, 4)
                    cur_depth = init_depth                       # (B,h,w)
                    depth_predictions.append(init_depth)
                else:
                    # ----- dynamic cost volume around the current depth -----
                    cur_depth = depth_predictions[-1].detach()
                    view_weights = _repeat2x_hw(view_weights, 2, 3)
                    # the depths the warps take: all rows where the warps run
                    # over all rows, else this rank's
                    (warp_depth,) = (par.gather_rows(cur_depth, axis=1)
                                     if warp_all else (cur_depth,))
                    drs_disp = geometry.depth_range_samples_local(
                        1.0 / warp_depth, cfg.ndepths[s],
                        _bshape(interval_s, 3))
                    depth_samples = 1.0 / drs_disp               # (B,8,h,w)

                    sims = warp(depth_samples[:, pre])
                    vw_ = view_weights[:, :, None]
                    sim_sum, w_sum = par.sum_views(
                        torch.sum(sims * vw_, dim=1), torch.sum(vw_, dim=1))
                    # (B,8,h,w,1), or this rank's D-block or row block of it
                    fresh = keep(sim_sum / (w_sum + 1e-6), 2,
                                 rows_out)[:, post][..., None]
                    depth_samples = keep(depth_samples, 2, rows_out)

                    new_dmax = depth_samples[:, 0:1]             # (B,1,h,w)
                    new_dmin = depth_samples[:, -1:]

                    # cross-scale propagation: previous-stage volumes resampled
                    # at the new hypotheses (nearest-downsampled x2), fused in
                    ds_low = depth_samples[:, pre][:, post, ::2, ::2]
                    reg_low = resample_volume_at_depths(
                        reg_volume, ds_low, vol_dmin, vol_dmax)
                    cur_low = resample_volume_at_depths(
                        cur_volume, ds_low, vol_dmin, vol_dmax)
                    with par.row_blocks(not depth_all):
                        reg_volume = getattr(self, f"CSP_R{s}")(
                            fresh.to(dt), reg_low[..., None].to(dt)).float()
                        cur_volume = getattr(self, f"CSP_C{s}")(
                            fresh.to(dt), cur_low[..., None].to(dt)).float()
                    reg_volume, cur_volume = par.gather_depths(reg_volume,
                                                               cur_volume)
                    vol_dmin, vol_dmax = new_dmin, new_dmax

                # ----- ConvGRU refinement over the stored volumes -----
                inv_cur_depth = geometry.depth_to_disp(
                    cur_depth, _bshape(depth_min_g, 3),
                    _bshape(depth_max_g, 3))

                def get_cost(depth, cur_volume=gru_rows(cur_volume),
                             reg_volume=gru_rows(reg_volume),
                             vol_dmin=gru_rows(vol_dmin),
                             vol_dmax=gru_rows(vol_dmax),
                             interval_s=interval_s):
                    """depth (B,h,w,1) -> (B,h,w,CostNum*cost_num) lookup."""
                    drs = geometry.depth_range_samples_local(
                        1.0 / depth[..., 0], cfg.CostNum,
                        _bshape(interval_s, 3))
                    ds = 1.0 / drs                               # (B,K,h,w)
                    c_cur = resample_volume_at_depths(cur_volume, ds, vol_dmin,
                                                      vol_dmax)
                    c_reg = resample_volume_at_depths(reg_volume, ds, vol_dmin,
                                                      vol_dmax)
                    return torch.cat([c_cur, c_reg], dim=1).permute(
                        0, 2, 3, 1).to(dt)

                ub = getattr(self, f"update_block_depth{s + 1}")
                _, mask, inv_depth_list = ub(
                    hiddens[s].to(dt), get_cost, inv_cur_depth[..., None],
                    contexts[s].to(dt), cfg.gru_iters[s], scale_inv_depth)

                for inv_d in inv_depth_list:
                    depth_predictions.append(
                        scale_inv_depth(inv_d[..., 0].float())[1])
                inv_up = convex_upsample(inv_depth_list[-1][..., 0].float(),
                                         mask.float(), cfg.feat_ratio[s])
                depth_predictions.append(scale_inv_depth(inv_up)[1])

        return depth_predictions, photometric_confidence_map
