"""DTU training reader, the port's copy of
``effi_mvs_plus_tpu/data/datasets.py::DTUTrainDataset`` (numpy only).

``__getitem__`` returns a dict of numpy arrays, channels-last:
  imgs            (V, H, W, 3) float32 in [0,1]
  proj_matrices   {'stage0'..'stage4': (V, 2, 4, 4)}
  depth_values    (Nd,) ascending inverse depths
  depth, mask     {'stage1'..'stage4': (h, w)}
  filename        output-path template

The JAX reader resizes with its C++ data plane or cv2; the port may use
neither, so it keeps its own nearest-neighbour resize (``_resize_nearest``,
cv2's rule: source index ``int(dst * src_size / dst_size)``), which is the
only resize this reader needs.  Images are decoded with PIL, as there.
"""

from __future__ import annotations

import os
import random

import numpy as np

from effi_mvs_plus_tpu_torch.data import cams as camio
from effi_mvs_plus_tpu_torch.data.pfm import read_pfm


def _imread(path):
    from PIL import Image
    return np.array(Image.open(path), dtype=np.float32) / 255.0


def _resize_nearest(img, wh):
    """cv2.resize(img, wh, interpolation=INTER_NEAREST) for float32."""
    sh, sw = img.shape[:2]
    dw, dh = wh
    ys = np.minimum((np.arange(dh) * (sh / dh)).astype(np.int64), sh - 1)
    xs = np.minimum((np.arange(dw) * (sw / dw)).astype(np.int64), sw - 1)
    return np.ascontiguousarray(np.asarray(img, np.float32)[ys][:, xs])


def _gt_pyramid(arr):
    """GT depth/mask at stages 1..4 via nearest resize."""
    h, w = arr.shape
    return {
        "stage1": _resize_nearest(arr, (w // 8, h // 8)),
        "stage2": _resize_nearest(arr, (w // 4, h // 4)),
        "stage3": _resize_nearest(arr, (w // 2, h // 2)),
        "stage4": arr,
    }


def _read_scan_list(listfile):
    if isinstance(listfile, (list, tuple)):
        return list(listfile)
    with open(listfile) as f:
        return [ln.rstrip() for ln in f if ln.strip()]


class DTUTrainDataset:
    """Yao Yao's preprocessed DTU training set.

    Metas = scans x 49 ref views x 7 light conditions (train) / light 3
    (val/test).  Images are the 640x512 rectified crops; GT depth read at
    1600x1200 then half-scaled + centre-cropped to 640x512; depth-range
    vector from the cam file with interval 2.5 * 1.06/(ndepths/192).
    ``crop_wh`` centre-crops larger images and shifts the principal point
    to match.
    """

    def __init__(self, datapath, listfile, mode, nviews, ndepths=384,
                 disp_max_first=False, rng=None, crop_wh=(640, 512)):
        assert mode in ("train", "val", "test")
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = 1.06 / (float(ndepths) / 192.0)
        self.disp_max_first = disp_max_first
        self.rng = rng or random.Random(0)
        self.crop_wh = crop_wh
        self.metas = []
        pair = camio.read_pair_file(
            os.path.join(datapath, "Cameras/pair.txt"))
        for scan in _read_scan_list(listfile):
            for ref, srcs in pair:
                lights = range(7) if mode == "train" else [3]
                for light in lights:
                    self.metas.append((scan, light, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def image_path(self, scan, light, vid):
        return os.path.join(
            self.datapath,
            f"Rectified/{scan}_train/rect_{vid + 1:03d}_{light}_r5000.png")

    def cam_path(self, vid):
        return os.path.join(self.datapath, f"Cameras/train/{vid:08d}_cam.txt")

    def mask_path(self, scan, vid):
        return os.path.join(self.datapath,
                            f"Depths_raw/{scan}/depth_visual_{vid:04d}.png")

    def depth_path(self, scan, vid):
        return os.path.join(self.datapath,
                            f"Depths_raw/{scan}/depth_map_{vid:04d}.pfm")

    def _crop_offset(self, hw):
        """Centre-crop offset (sh, sw) taking an (h, w) image to crop_wh;
        zero when the image is already crop-sized."""
        h, w = hw
        tw, th = self.crop_wh
        if (w, h) == (tw, th):
            return 0, 0
        if w < tw or h < th:
            raise ValueError(
                f"images are {w}x{h} but crop_wh={self.crop_wh} — the crop "
                "must not exceed the image")
        return (h - th) // 2, (w - tw) // 2

    def crop_image(self, img):
        sh, sw = self._crop_offset(img.shape[:2])
        tw, th = self.crop_wh
        return img[sh:sh + th, sw:sw + tw]

    def camera(self, vid, image_hw):
        """Cam file -> (extrinsics, intrinsics, depth_min), the principal
        point shifted for the centre crop of an image of native size
        image_hw.  DTU cam files carry quarter-resolution intrinsics, so
        the full-resolution offset is divided by 4."""
        cam = camio.read_cam_file(self.cam_path(vid))
        intr = cam["intrinsics"]
        sh, sw = self._crop_offset(image_hw)
        if sh or sw:
            intr = intr.copy()
            intr[0, 2] -= sw / 4.0
            intr[1, 2] -= sh / 4.0
        return cam["extrinsics"], intr, cam["depth_fields"][0]

    def depth_values_of(self, depth_min):
        return camio.inverse_depth_values(
            depth_min, 2.5 * self.interval_scale, self.ndepths,
            self.disp_max_first)

    def load_gt_pyramids(self, scan, vid):
        """(depth, mask) stage1..4 pyramids: raw GT half-scaled then
        centre-cropped to crop_wh; mask is depth_visual > 10/255."""
        mask_hr = (np.array(_imread(self.mask_path(scan, vid)) * 255.0)
                   > 10).astype(np.float32)
        depth_hr = read_pfm(self.depth_path(scan, vid))[0]
        return (_gt_pyramid(self._prepare_hr(depth_hr)),
                _gt_pyramid(self._prepare_hr(mask_hr)))

    def _prepare_hr(self, hr):
        h, w = hr.shape
        ds = _resize_nearest(hr, (w // 2, h // 2))
        h, w = ds.shape
        tw, th = self.crop_wh
        sh, sw = (h - th) // 2, (w - tw) // 2
        return ds[sh:sh + th, sw:sw + tw]

    def __getitem__(self, idx):
        scan, light, ref, srcs = self.metas[idx]
        if self.mode == "train":
            src_ids = self.rng.sample(srcs, self.nviews - 1)
        else:
            src_ids = srcs[:self.nviews - 1]
        view_ids = [ref] + src_ids

        imgs, projs = [], []
        depth_values = depth_ms = mask_ms = None
        for i, vid in enumerate(view_ids):
            img = _imread(self.image_path(scan, light, vid))
            native_hw = img.shape[:2]
            img = self.crop_image(img)
            ext, intr, depth_min = self.camera(vid, native_hw)
            projs.append(camio.stage_proj_matrices(ext, intr))
            imgs.append(img)
            if i == 0:
                depth_values = self.depth_values_of(depth_min)
                depth_ms, mask_ms = self.load_gt_pyramids(scan, vid)

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": {k: np.stack([p[k] for p in projs])
                              for k in projs[0]},
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }
