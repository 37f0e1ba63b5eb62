"""A training set held on the device, with batches assembled there.

The port of ``effi_mvs_plus_tpu/data/device_cache.py``.  DTU-style metas
are combinatorial (scan x ref x light, with source views drawn per
sample), so thousands of training samples share a few hundred distinct
images and ground-truth maps.  The cache uploads each distinct image once
(as uint8, the exact 8-bit source, cropped by the dataset), each
(scan, ref) ground-truth pyramid once (depth fp32, mask uint8) and each
view's stage projections and depth values once, and assembles every batch
on the device by indexing those tensors with a few rows of int64: the
per-step host-to-device traffic is the index rows.  An image is x / 255
as the JAX cache rounds it (x times the fp32 reciprocal), within one ulp
of the streaming reader's.

It draws the JAX cache's order and source views: epoch e's permutation
and every sample's sources come from ``numpy.random.default_rng(seed +
e)``, the permutation first, then ``rng.choice(len(srcs), nviews - 1,
replace=False)`` per sample in train mode (not the streaming reader's
``random.Random.sample``).  Under data parallelism (``shard``) every rank
walks the same global batches and assembles its rows of each.

Scope, as in JAX: ``DTUTrainDataset`` (train and eval splits).  A set
whose estimated size exceeds ``budget_bytes`` is refused before any
upload; stream it with ``data/loader.py`` instead.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from effi_mvs_plus_tpu_torch.data import cams as camio
from effi_mvs_plus_tpu_torch.data.datasets import DTUTrainDataset
from effi_mvs_plus_tpu_torch.device import resolve_device


class DeviceCacheLoader:
    """Loader-compatible iterable (``__len__``, ``__iter__`` yielding
    batch pytrees of tensors on ``device``) backed by a cache on that
    device (``cuda`` unless told otherwise).  ``shard=(parts, index)``
    keeps rows ``[index * n, (index + 1) * n)`` of every global batch of
    ``batch_size`` rows, ``n = batch_size / parts``."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 drop_last=False, budget_bytes=8 << 30, device=None,
                 shard=(1, 0)):
        from PIL import Image
        if not isinstance(dataset, DTUTrainDataset):
            raise ValueError(
                f"the device cache takes DTUTrainDataset's layout (metas of "
                f"(scan, light, ref, srcs)), not {type(dataset).__name__}'s, "
                f"as the JAX package's cache; stream it with the Loader")
        parts, index = shard
        if batch_size % parts:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{parts} data ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = resolve_device(device)
        n = batch_size // parts
        self._rows = slice(n * index, n * (index + 1))
        self._epoch = 0

        # dedupe image rows by realpath: light conditions aliased by
        # symlinks (or repeated views) share one row
        img_keys, gt_keys, path_rows = {}, {}, {}
        for scan, light, ref, srcs in dataset.metas:
            for vid in [ref] + list(srcs):
                k = (scan, light, vid)
                if k not in img_keys:
                    rp = os.path.realpath(dataset.image_path(scan, light, vid))
                    img_keys[k] = path_rows.setdefault(rp, len(path_rows))
            gt_keys.setdefault((scan, ref), len(gt_keys))
        self._img_keys, self._gt_keys = img_keys, gt_keys

        # the size check, before any upload (rows hold the cropped images)
        native = np.asarray(Image.open(next(iter(path_rows))))
        native_hw = native.shape[:2]
        probe = dataset.crop_image(native)
        est = (len(path_rows) * probe.nbytes
               + len(gt_keys) * probe.shape[0] * probe.shape[1] * 4 * 2
               * 1.33)
        if est > budget_bytes:
            raise ValueError(
                f"device cache would need ~{est / 1e9:.1f} GB "
                f"(> {budget_bytes / 1e9:.1f} GB budget); use the "
                "streaming Loader for datasets that exceed device memory")

        imgs = np.zeros((len(path_rows),) + probe.shape, np.uint8)
        for rp, row in path_rows.items():
            imgs[row] = dataset.crop_image(np.asarray(Image.open(rp)))

        depth, mask = None, None
        for (scan, vid), row in gt_keys.items():
            d_ms, m_ms = dataset.load_gt_pyramids(scan, vid)
            if depth is None:
                depth = {k: np.zeros((len(gt_keys),) + v.shape, np.float32)
                         for k, v in d_ms.items()}
                mask = {k: np.zeros((len(gt_keys),) + v.shape, np.uint8)
                        for k, v in m_ms.items()}
            for k in depth:
                depth[k][row] = d_ms[k]
                mask[k][row] = m_ms[k] > 0.5

        vids = sorted({vid for (_, _, vid) in img_keys})
        self._vid_row = {v: i for i, v in enumerate(vids)}
        projs, dvals = {}, []
        for vid in vids:
            ext, intr, depth_min = dataset.camera(vid, native_hw)
            for k, v in camio.stage_proj_matrices(ext, intr).items():
                projs.setdefault(k, []).append(v)
            dvals.append(dataset.depth_values_of(depth_min))

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._arrs = {
            "imgs": up(imgs),
            "depth": {k: up(v) for k, v in depth.items()},
            "mask": {k: up(v) for k, v in mask.items()},
            "projs": {k: up(np.stack(v)) for k, v in projs.items()},
            "depth_values": up(np.stack(dvals).astype(np.float32)),
        }
        # the JAX cache's conversion: XLA rounds x / 255 as x times the
        # fp32 reciprocal, which is within one ulp of the reader's x / 255
        self._inv255 = torch.full((), np.float32(1) / np.float32(255),
                                  device=self.device)

    def nbytes(self):
        def leaves(x):
            if isinstance(x, dict):
                return [t for v in x.values() for t in leaves(v)]
            return [x]
        return sum(t.numel() * t.element_size() for t in leaves(self._arrs))

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _gather(self, img_rows, proj_rows, gt_rows):
        a = self._arrs

        def idx(x):
            return torch.from_numpy(x).to(self.device)
        img_rows, proj_rows, gt_rows = idx(img_rows), idx(proj_rows), idx(
            gt_rows)
        return {
            "imgs": a["imgs"][img_rows].float() * self._inv255,
            "proj_matrices": {k: v[proj_rows]
                              for k, v in a["projs"].items()},
            "depth": {k: v[gt_rows] for k, v in a["depth"].items()},
            "mask": {k: v[gt_rows].float() for k, v in a["mask"].items()},
            "depth_values": a["depth_values"][proj_rows[:, 0]],
        }

    def __iter__(self):
        ds = self.dataset
        order = np.arange(len(ds.metas))
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        for bi in range(len(self)):
            sel = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            img_rows = np.zeros((len(sel), ds.nviews), np.int64)
            proj_rows = np.zeros((len(sel), ds.nviews), np.int64)
            gt_rows = np.zeros((len(sel),), np.int64)
            for r, mi in enumerate(sel):
                scan, light, ref, srcs = ds.metas[mi]
                if ds.mode == "train":
                    src_ids = list(rng.choice(len(srcs), ds.nviews - 1,
                                              replace=False))
                    view_ids = [ref] + [srcs[j] for j in src_ids]
                else:
                    view_ids = [ref] + list(srcs[:ds.nviews - 1])
                for v, vid in enumerate(view_ids):
                    img_rows[r, v] = self._img_keys[(scan, light, vid)]
                    proj_rows[r, v] = self._vid_row[vid]
                gt_rows[r] = self._gt_keys[(scan, ref)]
            rows = self._rows
            yield self._gather(img_rows[rows], proj_rows[rows], gt_rows[rows])
