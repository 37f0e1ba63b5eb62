"""Dataset readers, the port's copies of
``effi_mvs_plus_tpu/data/datasets.py`` (numpy only):

* DTUTrainDataset     — DTU training (Yao Yao's preprocessed set)
* GeneralEvalDataset  — DTU testing layout, file-list driven
* BlendedMVSDataset   — BlendedMVS low-res fine-tuning
* TanksDataset        — Tanks & Temples

``__getitem__`` returns a dict of numpy arrays, channels-last:
  imgs            (V, H, W, 3) float32 in [0,1]
  proj_matrices   {'stage0'..'stage4': (V, 2, 4, 4)}
  depth_values    (Nd,) ascending inverse depths
  [depth, mask]   {'stage1'..'stage4': (h, w)}        (training sets)
  filename        output-path template

The JAX readers resize with its C++ data plane or cv2; the port may use
neither, so it keeps its own resizes with cv2's rules for float32 images:
``_resize_nearest`` (source index ``int(dst * src_size / dst_size)``) and
``_resize_bilinear`` (``INTER_LINEAR``).  Images are decoded with PIL, as
there.
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


def _linear_taps(src, dst):
    """cv2 INTER_LINEAR taps along one axis: half-pixel centres, the
    coordinate clamped to the edge pixels.  The coordinate and its
    fraction are taken in float64 and only the weight is rounded to
    float32, as cv2 does: a float32 coordinate near 1000 would move the
    weight by up to 6e-5."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    a = (f - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= src - 1
    i0[low], a[low] = 0, 0.0
    i0[high], a[high] = src - 1, 0.0
    return i0, np.minimum(i0 + 1, src - 1), a


def _resize_bilinear(img, wh):
    """cv2.resize(img, wh, interpolation=INTER_LINEAR) for float32: no
    antialiasing, a horizontal then a vertical two-tap pass.  An axis
    whose size does not change is skipped: its taps are the identity with
    weight 0, so skipping it is exact, and the T&T reader resizes 1920-wide
    images to 1920 wide."""
    src = np.asarray(img, np.float32)
    out = src
    dw, dh = wh
    extra = (1,) * (src.ndim - 2)
    if dw != src.shape[1]:
        x0, x1, ax = _linear_taps(src.shape[1], dw)
        ax = ax.reshape(1, dw, *extra)
        out = out[:, x0] * (1 - ax) + out[:, x1] * ax
    if dh != src.shape[0]:
        y0, y1, ay = _linear_taps(src.shape[0], dh)
        ay = ay.reshape(dh, 1, *extra)
        out = out[y0] * (1 - ay) + out[y1] * ay
    return out.copy() if out is img else np.ascontiguousarray(out)


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


class GeneralEvalDataset:
    """File-list-driven eval reader (DTU testing layout).

    Cam-file intrinsics are full-resolution and divided by 4 at load;
    images resized to the max_h x max_w budget snapped down to multiples
    of 32 with intrinsics rescale; per-scene consistent sizing via
    fix_res/fix_wh.
    """

    def __init__(self, datapath, listfile, nviews, ndepths=384,
                 interval_scale=1.06, max_h=1184, max_w=1600,
                 fix_res=False, disp_max_first=False):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.max_h, self.max_w = max_h, max_w
        self.fix_res = fix_res
        self.fix_wh = False
        self.disp_max_first = disp_max_first
        self._s_hw = None
        self.metas = []
        for scan in _read_scan_list(listfile):
            for ref, srcs in camio.read_pair_file(
                    os.path.join(datapath, scan, "pair.txt")):
                if len(srcs) > 0:
                    if len(srcs) < nviews:
                        srcs = srcs + [srcs[0]] * (nviews - len(srcs))
                    self.metas.append((scan, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path):
        cam = camio.read_cam_file(path)
        intr = cam["intrinsics"].copy()
        intr[:2, :] /= 4.0
        fields = cam["depth_fields"]
        depth_min = fields[0]
        depth_interval = 2.5
        if len(fields) >= 3:
            depth_max = depth_min + int(fields[2]) * depth_interval
            depth_interval = (depth_max - depth_min) / self.ndepths
        depth_interval *= self.interval_scale
        return cam["extrinsics"], intr, depth_min, depth_interval

    def _scale_input(self, img, intr, base=32):
        h, w = img.shape[:2]
        new_w = int((1.0 * self.max_w / w * w) // base * base)
        new_h = int((1.0 * self.max_h / h * h) // base * base)
        intr = intr.copy()
        intr[0, :] *= 1.0 * new_w / w
        intr[1, :] *= 1.0 * new_h / h
        return _resize_bilinear(img, (new_w, new_h)), intr

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[:self.nviews - 1]
        imgs, projs = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, scan,
                                    f"images_post/{vid:08d}.jpg")
            if not os.path.exists(img_path):
                img_path = os.path.join(self.datapath, scan,
                                        f"images/{vid:08d}.jpg")
            img = _imread(img_path)
            ext, intr, dmin, dint = self._read_cam(os.path.join(
                self.datapath, scan, f"cams/{vid:08d}_cam.txt"))
            img, intr = self._scale_input(img, intr)

            if self.fix_res:
                self._s_hw = img.shape[:2]
                self.fix_res = False
                self.fix_wh = True
            if i == 0 and not self.fix_wh:
                self._s_hw = img.shape[:2]
            s_h, s_w = self._s_hw
            c_h, c_w = img.shape[:2]
            if (c_h, c_w) != (s_h, s_w):
                intr[0, :] *= 1.0 * s_w / c_w
                intr[1, :] *= 1.0 * s_h / c_h
                img = _resize_bilinear(img, (s_w, s_h))

            imgs.append(img)
            projs.append(camio.stage_proj_matrices(ext, intr))
            if i == 0:
                depth_values = camio.inverse_depth_values(
                    dmin, dint, self.ndepths, self.disp_max_first)

        return {
            "imgs": np.stack(imgs).astype(np.float32, copy=False),
            "proj_matrices": {k: np.stack([p[k] for p in projs])
                              for k in projs[0]},
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }


class BlendedMVSDataset:
    """BlendedMVS low-res fine-tuning reader (768x576 images).

    Layout ``<root>/<scan>/{blended_images/NNNNNNNN.jpg,
    cams/NNNNNNNN_cam.txt, cams/pair.txt,
    rendered_depth_maps/NNNNNNNN.pfm}``.  A ref with fewer than 7 sources
    is dropped; cam line 11 is [depth_min, interval, num, depth_max]; the
    sweep is ``linspace(1/depth_max, 1/depth_min, ndepths,
    endpoint=False)`` (descending with ``disp_max_first``); the mask is
    the ground truth inside [depth_min, depth_max]; intrinsics are divided
    by 4 to the stage-2 baseline.  ``mode == "finetune"`` samples the
    sources with ``rng.sample`` (``random.Random(0)`` unless one is
    given); every other mode takes the first ``nviews - 1``.
    """

    def __init__(self, datapath, listfile, mode, nviews, ndepths=384,
                 disp_max_first=False, rng=None):
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.disp_max_first = disp_max_first
        self.rng = rng or random.Random(0)
        self.metas = []
        for scan in _read_scan_list(listfile):
            pair_path = os.path.join(datapath, scan, "cams", "pair.txt")
            for ref, srcs in camio.read_pair_file(pair_path):
                if len(srcs) >= 7:
                    self.metas.append((scan, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        if self.mode == "finetune":
            src_ids = self.rng.sample(srcs, self.nviews - 1)
        else:
            src_ids = srcs[:self.nviews - 1]
        view_ids = [ref] + src_ids

        imgs, projs = [], []
        depth_values = depth_ms = mask_ms = None
        for i, vid in enumerate(view_ids):
            img = _imread(os.path.join(
                self.datapath, scan, f"blended_images/{vid:08d}.jpg"))
            cam = camio.read_cam_file(os.path.join(
                self.datapath, scan, f"cams/{vid:08d}_cam.txt"))
            intr = cam["intrinsics"].copy()
            intr[:2, :] /= 4.0     # the stage-2 baseline is quarter res
            projs.append(camio.stage_proj_matrices(cam["extrinsics"], intr))
            imgs.append(img)
            if i == 0:
                fields = cam["depth_fields"]
                depth_min, depth_max = fields[0], fields[-1]
                lo, hi = 1.0 / depth_max, 1.0 / depth_min
                if self.disp_max_first:
                    depth_values = np.linspace(
                        hi, lo, self.ndepths, endpoint=False,
                        dtype=np.float32)
                else:
                    depth_values = np.linspace(
                        lo, hi, self.ndepths, endpoint=False,
                        dtype=np.float32)
                depth = read_pfm(os.path.join(
                    self.datapath, scan,
                    f"rendered_depth_maps/{vid:08d}.pfm"))[0]
                mask = ((depth >= depth_min) & (depth <= depth_max)
                        ).astype(np.float32)
                depth_ms = _gt_pyramid(depth)
                mask_ms = _gt_pyramid(mask)

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": {k: np.stack([p[k] for p in projs])
                              for k in projs[0]},
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }


TANK_INTERMEDIATE = ("Family", "Francis", "Horse", "Lighthouse", "M60",
                     "Panther", "Playground", "Train")
TANK_ADVANCED = ("Auditorium", "Ballroom", "Courtroom", "Museum", "Palace",
                 "Temple")


def tank_split(scene):
    """The T&T split directory a scene lives under."""
    return "intermediate" if scene in TANK_INTERMEDIATE else "advanced"


class TanksDataset:
    """Tanks & Temples eval reader: images resized to target_wh (1920x1056)
    with intrinsics rescale; depth range from cam line 11."""

    def __init__(self, datapath, scans, nviews=11, ndepths=384,
                 target_wh=(1920, 1056), disp_max_first=False):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.target_wh = target_wh
        self.disp_max_first = disp_max_first
        self.metas = []
        for scan in scans:
            split = tank_split(scan)
            base = os.path.join(datapath, split, scan)
            for ref, srcs in camio.read_pair_file(
                    os.path.join(base, "pair.txt")):
                if len(srcs) > 0:
                    self.metas.append((scan, split, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, split, ref, srcs = self.metas[idx]
        view_ids = ([ref] + srcs)[:self.nviews]
        base = os.path.join(self.datapath, split, scan)
        tw, th = self.target_wh
        imgs, projs = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img = _imread(os.path.join(base, f"images/{vid:08d}.jpg"))
            # cams_1/ is the long-range camera set of the standard
            # preprocessed T&T; per-scene and plain cams/ layouts follow
            cam_dir = next(
                (d for d in ("cams_1", f"cams_{scan.lower()}", "cams")
                 if os.path.exists(os.path.join(base, d))), "cams")
            cam = camio.read_cam_file(
                os.path.join(base, cam_dir, f"{vid:08d}_cam.txt"))
            h, w = img.shape[:2]
            intr = cam["intrinsics"].copy()
            intr[0, :] *= tw / w
            intr[1, :] *= th / h
            img = _resize_bilinear(img, (tw, th))
            # the stage2 baseline is quarter resolution
            intr_q = intr.copy()
            intr_q[:2, :] /= 4.0
            projs.append(camio.stage_proj_matrices(cam["extrinsics"], intr_q))
            imgs.append(img)
            if i == 0:
                # a 4-field line 11 is [min, interval, num, max]: max is
                # field 3; a short line is [min, max]: field 1 is depth_max,
                # not an interval
                fields = cam["depth_fields"]
                depth_min = fields[0]
                depth_max = fields[3] if len(fields) >= 4 else fields[1]
                lo, hi = 1.0 / depth_max, 1.0 / depth_min
                if self.disp_max_first:
                    depth_values = np.linspace(hi, lo, self.ndepths,
                                               dtype=np.float32)
                else:
                    depth_values = np.linspace(lo, hi, self.ndepths,
                                               dtype=np.float32)

        return {
            "imgs": np.stack(imgs).astype(np.float32, copy=False),
            "proj_matrices": {k: np.stack([p[k] for p in projs])
                              for k in projs[0]},
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }
