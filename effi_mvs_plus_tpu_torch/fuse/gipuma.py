"""Gipuma/fusibile export: the port of ``effi_mvs_plus_tpu/fuse/gipuma.py``.

Converts a scene's saved depth maps, confidences and cameras into the
Gipuma layout — ``.dmb`` binary maps, P-matrix camera files, fake normal
maps facing the camera — with the probability filter applied, and runs
an external ``fusibile`` executable on it.  That executable is
third-party CUDA code the repo does not hold; ``run_fusibile`` takes its
path.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np

from effi_mvs_plus_tpu_torch.data.cams import read_cam_file
from effi_mvs_plus_tpu_torch.data.datasets import _resize_bilinear
from effi_mvs_plus_tpu_torch.data.pfm import read_pfm


def write_dmb(path, arr):
    """A Gipuma binary map: int32 type (1), h, w, channels, then the
    float32 data."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, h, w, c))
        arr.tofile(f)


def read_dmb(path):
    """The array of a ``.dmb`` file: (h, w), or (h, w, c) for c > 1."""
    with open(path, "rb") as f:
        _t, h, w, c = struct.unpack("<iiii", f.read(16))
        data = np.frombuffer(f.read(), "<f4").reshape(h, w, c)
    return data[:, :, 0] if c == 1 else data


def write_gipuma_cam(path, extrinsics, intrinsics):
    """P = K @ E[:3, :4] as a 3x4 text matrix."""
    P = np.asarray(intrinsics) @ np.asarray(extrinsics)[:3, :4]
    with open(path, "w") as f:
        for row in P:
            f.write(" ".join(f"{v:f}" for v in row) + "\n")
        f.write("\n")


def fake_normal(depth):
    """Unit normals facing the camera, (h, w, 3)."""
    h, w = depth.shape
    n = np.zeros((h, w, 3), np.float32)
    n[:, :, 2] = -1.0
    return n


def convert_scene(out_folder, gipuma_folder, view_ids, prob_threshold=0.3):
    """A scene's saved outputs (``depth_est/``, ``confidence/``,
    ``cams/``, ``images/``) -> the fusibile input layout: per view
    ``2333_<id>/disp.dmb`` and ``normals.dmb``, ``cams/<id>.jpg.P`` and
    ``images/<id>.jpg``.  A confidence of another size than its depth map
    is resized with cv2's INTER_LINEAR rules (``_resize_bilinear``), as
    the JAX package resizes it with cv2."""
    cam_dir = os.path.join(gipuma_folder, "cams")
    img_dir = os.path.join(gipuma_folder, "images")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    for vid in view_ids:
        name = f"{vid:08d}"
        cam = read_cam_file(os.path.join(out_folder, "cams",
                                         f"{name}_cam.txt"))
        write_gipuma_cam(os.path.join(cam_dir, f"{name}.jpg.P"),
                         cam["extrinsics"], cam["intrinsics"])
        src_img = os.path.join(out_folder, "images", f"{name}.jpg")
        if os.path.exists(src_img):
            shutil.copy(src_img, os.path.join(img_dir, f"{name}.jpg"))

        depth = read_pfm(os.path.join(out_folder, "depth_est",
                                      f"{name}.pfm"))[0]
        conf = read_pfm(os.path.join(out_folder, "confidence",
                                     f"{name}.pfm"))[0]
        if conf.shape != depth.shape:
            conf = _resize_bilinear(conf, (depth.shape[1], depth.shape[0]))
        depth = np.where(conf >= prob_threshold, depth, 0.0)

        view_dir = os.path.join(gipuma_folder, f"2333_{name}")
        os.makedirs(view_dir, exist_ok=True)
        write_dmb(os.path.join(view_dir, "disp.dmb"), depth)
        write_dmb(os.path.join(view_dir, "normals.dmb"), fake_normal(depth))


def run_fusibile(fusibile_exe, gipuma_folder, disp_threshold=0.2,
                 num_consistent=3):
    """Run an external fusibile executable on a converted scene; the
    ``subprocess.CompletedProcess`` with its output."""
    cmd = [fusibile_exe,
           "-input_folder", gipuma_folder + "/",
           "-p_folder", os.path.join(gipuma_folder, "cams") + "/",
           "-images_folder", os.path.join(gipuma_folder, "images") + "/",
           "--depth_min=0.001", "--depth_max=100000",
           f"--disp_thresh={disp_threshold}",
           f"--num_consistent={num_consistent}",
           "--cam_scale=1", "-gpu"]
    return subprocess.run(cmd, capture_output=True, text=True)
