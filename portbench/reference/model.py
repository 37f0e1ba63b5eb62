"""Effi-MVS+ in plain PyTorch: the benchmark's frozen reference.

A functional copy of the network's plain path, written from the
architecture (Effi-MVS+: an FPN, a stage-1 inverse-depth plane sweep with
pixel-wise view weights and a 3-D U-Net, dynamic 8-hypothesis cost
volumes with cross-scale propagation at stages 2-3, three ConvGRU
refinements a stage and convex x2 upsampling).  It holds no kernel, no
sharding hook and no state of the measured program: parameters are a
dict of tensors under the shipped state dict's names (``weights.py``
reads the ``.npz`` with numpy), tensors are channels-last, and the
arithmetic is float32.

``Reference(params, cfg)`` runs the forward; ``training=True`` takes BN
batch statistics (per view in the FPN, per source view in the view-weight
net) and draws the update blocks' channel-dropout masks from
``generator`` with one ``torch.rand`` of shape (B,1,1,C) a dropout, in the
order the blocks run.  ``quant`` rounds every convolution's and the
correlation's operands (the lower-precision control); ``counter`` records
the FLOPs of every convolution, correlation, GRU gate and upsampling,
with the backward counted apart, and the warps' inputs, for the
benchmark's work counts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS_BN = 1e-5
DROPOUT_P = 0.1


class Counter:
    """FLOPs of the forward and of its backward, and the warp calls
    (stage, rots, trs, hypotheses, source height, width, channels)."""

    def __init__(self):
        self.fwd = 0.0
        self.bwd = 0.0
        self.warps = []

    def add(self, flops, weights_grad, input_grad):
        self.fwd += flops
        self.bwd += flops * (int(weights_grad) + int(input_grad))


# ----------------------------------------------------------------- geometry

def compose_projection(p):
    """(..., 2, 4, 4) [extrinsics, intrinsics] -> (..., 4, 4) K·[R|t]."""
    ext, K = p[..., 0, :, :], p[..., 1, :3, :3]
    top = K @ ext[..., :3, :4]
    return torch.cat([top, ext[..., 3:4, :]], dim=-2)


def inv3x3(m):
    """Adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def relative_projection(src, ref):
    """rot = M_src M_ref^-1, trans = t_src - rot t_ref."""
    rot = src[..., :3, :3] @ inv3x3(ref[..., :3, :3])
    trans = src[..., :3, 3] - (rot @ ref[..., :3, 3:4])[..., 0]
    return rot, trans


def project(rot, trans, depth):
    """Reference pixels at depths (B,D,H,W) -> source pixels px, py."""
    B, D, H, W = depth.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=depth.dtype,
                                       device=depth.device),
                          torch.arange(W, dtype=depth.dtype,
                                       device=depth.device), indexing="ij")
    grid = torch.stack([x.reshape(-1), y.reshape(-1),
                        torch.ones(H * W, dtype=depth.dtype,
                                   device=depth.device)])
    ray = rot @ grid                                          # (B,3,HW)
    xyz = ray[:, :, None] * depth.reshape(B, 1, D, H * W) \
        + trans[:, :, None, None]
    z = xyz[:, 2]
    z = torch.where(z == 0, z + 1e-8, z)
    return ((xyz[:, 0] / z).reshape(B, D, H, W),
            (xyz[:, 1] / z).reshape(B, D, H, W))


def sweep_global(dv, n):
    """(B, Nd) ascending inverse depths -> (B, n, 1, 1) uniform sweep."""
    lo, hi = dv[:, 0], dv[:, -1]
    idx = torch.arange(n, dtype=dv.dtype, device=dv.device)
    return (lo[:, None] + idx[None] * ((hi - lo) / (n - 1))[:, None]
            )[:, :, None, None]


def sweep_local(cur, n, interval):
    """n inverse-depth samples around cur (B,H,W), interval (B,1,1)."""
    half = n // 2
    lo = torch.clamp(cur - half * interval, min=1e-4)
    hi = torch.clamp(cur + half * interval, 1e-4, 1e4)
    idx = torch.arange(n, dtype=cur.dtype, device=cur.device
                       )[None, :, None, None]
    return torch.clamp(lo[:, None] + idx * ((hi - lo) / (n - 1))[:, None],
                       min=1e-5)


def disp_to_depth(disp, dmin, dmax):
    lo, hi = 1.0 / dmax, 1.0 / dmin
    scaled = torch.clamp(lo + (hi - lo) * disp, min=1e-4)
    return scaled, 1.0 / scaled


def depth_to_disp(depth, dmin, dmax):
    lo, hi = 1.0 / dmax, 1.0 / dmin
    return (1.0 / depth - lo) / ((hi - lo) + 1e-10)


def _b(x, ndim):
    return x.reshape(x.shape[0], *([1] * (ndim - 1)))


# --------------------------------------------------------------- volume ops

def bilinear_gather(fea, px, py):
    """Zero-padded bilinear taps, align_corners=True.  fea (B,H,W,C);
    px, py (B,N) -> (B,N,C)."""
    B, H, W, C = fea.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    flat = fea.reshape(B, H * W, C)
    out = 0
    for xf, yf, wt in ((x0, y0, (1 - wx) * (1 - wy)),
                       (x0 + 1, y0, wx * (1 - wy)),
                       (x0, y0 + 1, (1 - wx) * wy),
                       (x0 + 1, y0 + 1, wx * wy)):
        inb = (xf >= 0) & (xf < W) & (yf >= 0) & (yf < H)
        idx = torch.where(inb, yf * W + xf, torch.zeros_like(xf)).long()
        v = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        out = out + v * torch.where(inb, wt, torch.zeros_like(wt))[..., None]
    return out


def resample_depth_axis(vol, x):
    """Linear taps along D at index positions x (B,K,H,W), zero outside."""
    D = vol.shape[1]
    x0 = torch.floor(x)
    out = torch.zeros_like(x)
    for tap, w in ((x0, 1.0 - (x - x0)), (x0 + 1.0, x - x0)):
        inb = (tap >= 0) & (tap <= D - 1)
        v = torch.gather(vol, 1, torch.where(inb, tap,
                                             torch.zeros_like(tap)).long())
        out = out + torch.where(inb, v * w, torch.zeros_like(v))
    return out


def resample_at_depths(vol, depths, dmin, dmax):
    """A volume uniform in normalised disparity over [dmin, dmax] (bin 0
    at dmax) resampled at actual depths (B,K,H,W)."""
    return resample_depth_axis(vol, depth_to_disp(depths, dmin, dmax)
                               * (vol.shape[1] - 1))


def photometric_confidence(prob):
    """Sum of the 4 bins around the expected index, read at its floor."""
    B, D, H, W = prob.shape
    p = F.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = p[:, 0:D] + p[:, 1:D + 1] + p[:, 2:D + 2] + p[:, 3:D + 3]
    ar = torch.arange(D, dtype=prob.dtype, device=prob.device)
    idx = torch.sum(prob * ar[None, :, None, None], 1).to(torch.int64)
    return torch.gather(sum4, 1, torch.clamp(idx, 0, D - 1)[:, None])[:, 0]


def _repeat2x(x, h_axis, w_axis):
    return x.repeat_interleave(2, h_axis).repeat_interleave(2, w_axis)


# ------------------------------------------------------------------ network

class Reference:
    """The network over a parameter dict.  cfg: ``ndepths``, ``cost_num``
    (hypotheses a GRU lookup), ``gru_iters``, ``hdim``, ``interval_ratio``
    (lists, as in the configuration files)."""

    def __init__(self, params, cfg, training=False, generator=None,
                 quant=None, counter=None):
        self.p = params
        self.nd = tuple(cfg["ndepths"])
        self.cost_num = int(cfg["cost_num"])
        self.iters = tuple(cfg["gru_iters"])
        self.hdim = tuple(cfg["hdim"])
        self.ratio = tuple(cfg["interval_ratio"])
        self.training = training
        self.generator = generator
        self.quant = quant
        self.counter = counter

    # layers --------------------------------------------------------------
    def _q(self, t):
        return t if self.quant is None else self.quant(t)

    def conv(self, x, name, stride=1, padding=0, transpose=False,
             output_padding=0, bias=True):
        """Channels-last convolution with ``name.weight`` (PyTorch's
        layouts) and, where given, ``name.bias``."""
        w = self.p[name + ".weight"]
        b = self.p.get(name + ".bias") if bias else None
        nd = w.dim() - 2
        xc = self._q(x).movedim(-1, 1)
        if transpose:
            y = F.conv_transpose3d(xc, self._q(w), None, stride, padding,
                                   output_padding)
            flops = 2.0 * x.numel() * w[0].numel()
        else:
            fn = F.conv2d if nd == 2 else F.conv3d
            y = fn(xc, self._q(w), None, stride, padding)
            flops = 2.0 * y[:, 0].numel() * w.numel()
        y = y.movedim(1, -1)
        if b is not None:
            y = y + b
        if self.counter is not None:
            self.counter.add(flops, w.requires_grad, x.requires_grad)
        return y

    def bn(self, x, name, groups=1):
        g = lambda k: self.p[f"{name}.{k}"]                      # noqa: E731
        if not self.training:
            inv = torch.rsqrt(g("running_var") + EPS_BN)
            return x * (g("weight") * inv) + (g("bias") - g("running_mean")
                                              * g("weight") * inv)
        xg = x.reshape(x.shape[0] // groups, groups, *x.shape[1:])
        axes = (0,) + tuple(range(2, xg.dim() - 1))
        mean = xg.mean(axes)
        var = (xg * xg).mean(axes) - mean * mean
        inv = torch.rsqrt(var + EPS_BN)
        shape = (1, groups) + (1,) * (xg.dim() - 3) + (-1,)
        scale = (g("weight") * inv).reshape(shape)
        shift = (g("bias") - mean * g("weight") * inv).reshape(shape)
        return (xg * scale + shift).reshape(x.shape)

    def block(self, x, name, groups=1, k=3, stride=1, transpose=False,
              output_padding=0):
        """conv (no bias) + BN + ReLU."""
        y = self.conv(x, name + ".conv", stride, k // 2, transpose,
                      output_padding, bias=False)
        return torch.relu(self.bn(y, name + ".bn", groups))

    def dropout(self, x):
        if not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= DROPOUT_P
        return torch.where(keep, x / (1.0 - DROPOUT_P), torch.zeros_like(x))

    # blocks --------------------------------------------------------------
    def fpn(self, name, x, groups):
        def level(i, x, first_k, stride, n):
            x = self.block(x, f"{name}.conv{i}.0", groups, first_k, stride)
            for j in range(1, n):
                x = self.block(x, f"{name}.conv{i}.{j}", groups)
            return x
        c0 = level(0, x, 3, 1, 2)
        c1 = level(1, c0, 5, 2, 3)
        c2 = level(2, c1, 5, 2, 3)
        c3 = level(3, c2, 5, 2, 3)
        out = {"stage1": self.conv(c3, f"{name}.out1", bias=False)}
        up = _repeat2x(c3, 1, 2) + self.conv(c2, f"{name}.inner1")
        out["stage2"] = self.conv(up, f"{name}.out2", padding=1, bias=False)
        up = _repeat2x(up, 1, 2) + self.conv(c1, f"{name}.inner2")
        out["stage3"] = self.conv(up, f"{name}.out3", padding=1, bias=False)
        return out

    def pixelwise(self, x, groups):
        for i in range(3):
            x = self.block(x, f"PixelwiseNet.{i}", groups)
        return torch.sigmoid(self.conv(x, "PixelwiseNet.3"))

    def cost_reg(self, x):
        n = "cost_regularization"
        c1 = self.block(self.block(x, f"{n}.conv0"), f"{n}.conv1")
        c3 = self.block(self.block(c1, f"{n}.conv2", stride=2), f"{n}.conv3")
        mid = self.block(self.block(c3, f"{n}.conv4", stride=2),
                         f"{n}.conv5")
        up = c3 + self.block(mid, f"{n}.conv6", stride=2, transpose=True,
                             output_padding=1)
        pro = c1 + self.block(up, f"{n}.conv7", stride=2, transpose=True,
                              output_padding=1)
        return self.conv(pro, f"{n}.prob", padding=1, bias=False)[..., 0]

    def csp(self, n, cur, prev):
        down = self.block(cur, f"{n}.conv0", stride=(1, 2, 2))
        emb = self.block(prev, f"{n}.conv_cost")
        fused = self.block(torch.cat([down, emb], -1), f"{n}.conv1")
        return self.block(fused, f"{n}.conv2", stride=(1, 2, 2),
                          transpose=True, output_padding=(0, 1, 1))[..., 0]

    def gru(self, n, h, x):
        hx = torch.cat([h, x], -1)
        z = torch.sigmoid(self.conv(hx, f"{n}.convz", padding=1))
        r = torch.sigmoid(self.conv(hx, f"{n}.convr", padding=1))
        q = torch.tanh(self.conv(torch.cat([r * h, x], -1), f"{n}.convq",
                                 padding=1))
        return (1 - z) * h + z * q

    def update(self, s, hidden, get_cost, inv_depth, context, to_depth):
        n = f"update_block_depth{s + 1}"
        e = f"{n}.encoder"
        inv_list = []
        for _ in range(self.iters[s]):
            inv_depth = inv_depth.detach()
            cost = get_cost(to_depth(inv_depth)[1])
            cor = torch.relu(self.conv(torch.relu(
                self.conv(cost, f"{e}.convc1")), f"{e}.convc2", padding=1))
            dfm = torch.relu(self.conv(torch.relu(
                self.conv(inv_depth, f"{e}.convd1", padding=3)),
                f"{e}.convd2", padding=1))
            y = self.conv(torch.cat([cor, dfm], -1), f"{e}.convd", padding=1)
            x = self.dropout(torch.relu(self.conv(torch.cat([y, context], -1),
                                                  f"{e}.convc")))
            hidden = self.gru(f"{n}.depth_gru", hidden, x)
            hh = torch.relu(self.conv(hidden, f"{n}.depth_head.conv1",
                                      padding=1))
            delta = torch.tanh(self.dropout(
                self.conv(hh, f"{n}.depth_head.conv2", padding=1)))
            inv_depth = inv_depth + delta
            inv_list.append(inv_depth)
        mask = 0.25 * self.conv(torch.relu(self.conv(hidden, f"{n}.mask.0",
                                                     padding=1)),
                                f"{n}.mask.2")
        return mask, inv_list

    def convex_upsample(self, value, mask, r=2):
        B, H, W = value.shape
        m = torch.softmax(mask.reshape(B, H, W, 9, r, r), dim=3)
        p = F.pad(value, (1, 1, 1, 1))
        nb = torch.stack([p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
        up = torch.einsum("bhwkyx,bhwk->bhwyx", m, nb)
        if self.counter is not None:
            self.counter.add(2.0 * m.numel(), False, value.requires_grad)
        return up.permute(0, 1, 3, 2, 4).reshape(B, H * r, W * r)

    def correlate(self, s, ref, src, rot, trans, depth):
        """(B,V,D,H,W): the mean over channels of the reference features
        times each source view's, bilinearly warped to each hypothesis."""
        B, H, W, C = ref.shape
        D = depth.shape[1]
        ref, src = self._q(ref), self._q(src)
        if self.counter is not None:
            self.counter.warps.append(dict(
                stage=s, rot=rot.detach(), trans=trans.detach(),
                depth=depth.detach(), h=src.shape[2], w=W, C=C))
            # 4 taps of 2 FLOPs a channel, the product and the sum
            self.counter.add(10.0 * C * B * src.shape[1] * D * H * W, False,
                             ref.requires_grad)
        sims = []
        for v in range(src.shape[1]):
            px, py = project(rot[:, v], trans[:, v], depth)
            wv = bilinear_gather(src[:, v], px.reshape(B, -1),
                                 py.reshape(B, -1)).reshape(B, D, H, W, C)
            sims.append(torch.mean(wv * ref[:, None], -1))
        return torch.stack(sims, 1)

    # forward -------------------------------------------------------------
    def forward(self, imgs, proj_matrices, depth_values):
        """imgs (B,V,H,W,3) in [0,1]; proj_matrices {'stage1'..'stage3':
        (B,V,2,4,4)}; depth_values (B,Nd) ascending inverse depths.
        Returns (13 depth maps coarse to fine, confidence (B,H/2,W/2))."""
        B, V, H, W, _ = imgs.shape
        dv = depth_values.float()
        dmax_g, dmin_g = 1.0 / dv[:, 0], 1.0 / dv[:, -1]
        interval = (dv[:, -1] - dv[:, 0]) / dv.shape[1]

        def to_depth(disp):
            return disp_to_depth(disp, _b(dmin_g, disp.dim()),
                                 _b(dmax_g, disp.dim()))

        feats = self.fpn("feature", imgs.reshape(B * V, H, W, 3), V)
        feats = {k: v.reshape(B, V, *v.shape[1:]) for k, v in feats.items()}
        cnet = self.fpn("cnet_depth", imgs[:, 0], 1)

        preds, conf_map = [], None
        reg = cur = vol_dmin = vol_dmax = view_w = None
        for s in range(3):
            f = feats[f"stage{s + 1}"]
            hd = self.hdim[s]
            hidden = torch.tanh(cnet[f"stage{s + 1}"][..., :hd])
            context = torch.relu(cnet[f"stage{s + 1}"][..., hd:])
            P = compose_projection(proj_matrices[f"stage{s + 1}"].float())
            rot, trans = relative_projection(P[:, 1:],
                                             P[:, :1].expand_as(P[:, 1:]))
            ref, src = f[:, 0], f[:, 1:]
            h, w = ref.shape[1], ref.shape[2]
            interval_s = interval * self.ratio[s]
            if s == 0:
                hyps = (1.0 / sweep_global(dv, self.nd[0])).expand(
                    B, self.nd[0], h, w)
                sims = self.correlate(s, ref, src, rot, trans, hyps)
                x = sims.detach()
                u = torch.exp(x - x.amax(2, keepdim=True))
                pn = u / u.sum(2, keepdim=True)
                entropy = -torch.sum(pn * torch.log(pn + 1e-7), 2)
                view_w = self.pixelwise(
                    entropy.reshape(B * (V - 1), h, w, 1), V - 1
                ).reshape(B, V - 1, h, w)
                vw = view_w[:, :, None]
                sim = (torch.sum(sims * vw, 1)
                       / (torch.sum(vw, 1) + 1e-6))[..., None]
                reg = self.cost_reg(sim)
                cur = sim[..., 0]
                prob = torch.softmax(reg, 1)
                cur_depth = torch.sum(prob * hyps, 1)
                conf = photometric_confidence(prob)
                conf_map = _repeat2x(_repeat2x(conf, 1, 2), 1, 2)
                vol_dmin, vol_dmax = _b(dmin_g, 4), _b(dmax_g, 4)
                preds.append(cur_depth)
            else:
                cur_depth = preds[-1].detach()
                view_w = _repeat2x(view_w, 2, 3)
                ds = 1.0 / sweep_local(1.0 / cur_depth, self.nd[s],
                                       _b(interval_s, 3))
                sims = self.correlate(s, ref, src, rot, trans, ds)
                vw = view_w[:, :, None]
                fresh = (torch.sum(sims * vw, 1)
                         / (torch.sum(vw, 1) + 1e-6))[..., None]
                low = ds[:, :, ::2, ::2]
                reg_low = resample_at_depths(reg, low, vol_dmin, vol_dmax)
                cur_low = resample_at_depths(cur, low, vol_dmin, vol_dmax)
                reg = self.csp(f"CSP_R{s}", fresh, reg_low[..., None])
                cur = self.csp(f"CSP_C{s}", fresh, cur_low[..., None])
                vol_dmin, vol_dmax = ds[:, -1:], ds[:, 0:1]

            def get_cost(depth, reg=reg, cur=cur, lo=vol_dmin, hi=vol_dmax,
                         interval_s=interval_s):
                d = 1.0 / sweep_local(1.0 / depth[..., 0], self.cost_num,
                                      _b(interval_s, 3))
                return torch.cat([resample_at_depths(cur, d, lo, hi),
                                  resample_at_depths(reg, d, lo, hi)],
                                 1).permute(0, 2, 3, 1)

            inv_cur = depth_to_disp(cur_depth, _b(dmin_g, 3), _b(dmax_g, 3))
            mask, inv_list = self.update(s, hidden, get_cost,
                                         inv_cur[..., None], context,
                                         to_depth)
            preds += [to_depth(d[..., 0])[1] for d in inv_list]
            preds.append(to_depth(self.convex_upsample(inv_list[-1][..., 0],
                                                       mask))[1])
        return preds, conf_map
