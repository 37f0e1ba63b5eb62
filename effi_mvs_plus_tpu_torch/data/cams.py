"""Camera-file and pair-file codecs (MVSNet text formats), and the
per-stage projection stacks the model consumes.

The port's own copy of ``effi_mvs_plus_tpu/data/cams.py`` (numpy only).

Format: line 0 'extrinsic', lines 1-4 the 4x4 world->cam matrix, line 6
'intrinsic', lines 7-9 the 3x3 K, line 11
``depth_min depth_interval [num_depth depth_max]``.
Pair files: first line = number of views, then per view two lines: ref
id, then ``num_src src0 score0 src1 score1 ...``.
"""

from __future__ import annotations

import numpy as np


def read_cam_file(path):
    """Returns dict with extrinsics (4,4), intrinsics (3,3) and the raw
    depth line fields [depth_min, interval, (num_depth, depth_max)...]."""
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extrinsics = np.array(" ".join(lines[1:5]).split(),
                          dtype=np.float32).reshape(4, 4)
    intrinsics = np.array(" ".join(lines[7:10]).split(),
                          dtype=np.float32).reshape(3, 3)
    depth_fields = [float(x) for x in lines[11].split()] if len(lines) > 11 \
        and lines[11].strip() else []
    return {"extrinsics": extrinsics, "intrinsics": intrinsics,
            "depth_fields": depth_fields}


def write_cam_file(path, extrinsics, intrinsics, depth_fields):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsics):
            f.write(" ".join(str(float(v)) for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsics):
            f.write(" ".join(str(float(v)) for v in row) + "\n")
        f.write("\n" + " ".join(str(float(v)) for v in depth_fields) + "\n")


def read_pair_file(path):
    """Returns list of (ref_view, [src_views]) with scores dropped."""
    pairs = []
    with open(path) as f:
        num = int(f.readline())
        for _ in range(num):
            ref = int(f.readline().rstrip())
            toks = f.readline().rstrip().split()
            pairs.append((ref, [int(x) for x in toks[1::2]]))
    return pairs


# intrinsics scale of stage0..stage4 against the stage2 (quarter) baseline
STAGE_SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)


def stage_proj_matrices(extrinsics, intrinsics):
    """Per-stage (2,4,4) stacks: slot 0 extrinsics, slot 1 K with rows 0-1
    scaled per pyramid stage.  `intrinsics` must already be at the stage2
    baseline resolution (quarter of full)."""
    base = np.zeros((2, 4, 4), dtype=np.float32)
    base[0] = extrinsics
    base[1, :3, :3] = intrinsics
    out = {}
    for i, s in enumerate(STAGE_SCALES):
        m = base.copy()
        m[1, :2, :] *= s
        out[f"stage{i}"] = m
    return out


def inverse_depth_values(depth_min, depth_interval, ndepth,
                         disp_max_first=False):
    """The (Nd,) inverse-depth sample vector the model consumes: linspace
    from 1/depth_max up to 1/depth_min (descending with
    ``disp_max_first``)."""
    depth_max = depth_interval * ndepth + depth_min
    lo, hi = 1.0 / depth_max, 1.0 / depth_min
    if disp_max_first:
        return np.linspace(hi, lo, ndepth, dtype=np.float32)
    return np.linspace(lo, hi, ndepth, dtype=np.float32)
