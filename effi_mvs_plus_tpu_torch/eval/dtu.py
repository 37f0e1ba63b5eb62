"""DTU chamfer evaluation, the port's copy of
``effi_mvs_plus_tpu/eval/dtu.py`` (numpy and scipy): the MATLAB protocol
in Python, so the pipeline needs no MATLAB:

1. ``reduce_pts``       — stochastic 0.2 mm-neighbourhood downsample of the
                          method cloud (reducePts_haa.m): visit points in a
                          random order; a still-kept point suppresses all
                          neighbours within dst.
2. chamfer distances    — data->stl (accuracy) and stl->data
                          (completeness) via cKDTree, distances clipped at
                          MaxDist=60 outside the STL bounding box
                          neighbourhood (MaxDistCP.m semantics).
3. masks                — accuracy uses only points inside the scan's
                          ObsMask voxel grid; completeness only STL points
                          above the ground plane (PointCompareMain.m).
4. stats                — 20 mm outlier cut; overall = (mean acc + mean
                          comp)/2 over the 22 eval scans
                          (ComputeStat_web.m:75-83).

ObsMask/Plane .mat files are read with scipy.io; STL ground truth with the
local PLY codec.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree


def reduce_pts(pts, dst=0.2, seed=0):
    """Stochastic downsample: no two kept points closer than dst.

    pts: (N,3).  Returns a boolean keep-mask.  Matches reducePts_haa.m's
    random-order suppression (the specific permutation differs — the
    protocol is stochastic by design; seeded here for reproducibility).

    The MATLAB loop (visit points in random order; a still-kept point
    suppresses all neighbours within dst) computes exactly the
    lexicographically-first maximal independent set of the dst-neighbour
    graph under the random priority order.  That has an exact parallel
    form (deterministic Luby rounds): a point is KEPT when its priority
    beats every still-undecided neighbour's, then its neighbours are
    REMOVED; repeat.  Each round is pure vectorised scatter-min — ~two
    orders of magnitude faster than the per-point Python loop at the
    ~30 M points of a real fused DTU cloud, with an identical result for
    a given priority order (tests/test_eval_dtu.py pins this against the
    sequential implementation).
    """
    n = len(pts)
    if n == 0:
        return np.zeros(0, bool)
    # position in the random visiting order = priority (lower wins)
    pri = np.empty(n, np.int64)
    pri[np.random.default_rng(seed).permutation(n)] = np.arange(n)

    tree = cKDTree(pts)
    pairs = tree.query_pairs(dst, output_type="ndarray")   # (P, 2) unique
    kept = np.zeros(n, bool)
    undecided = np.ones(n, bool)
    if len(pairs) == 0:
        return np.ones(n, bool)
    pairs = pairs.astype(np.int32, copy=False)
    a = np.concatenate([pairs[:, 0], pairs[:, 1]])         # both directions
    b = np.concatenate([pairs[:, 1], pairs[:, 0]])
    while True:
        # min neighbour priority over undecided neighbours (the sentinel n
        # makes neighbour-less points win their round automatically)
        minnb = np.full(n, n, np.int64)
        live = undecided[a] & undecided[b]
        np.minimum.at(minnb, a[live], pri[b[live]])
        newkeep = undecided & (pri < minnb)
        if not newkeep.any():
            break
        kept |= newkeep
        # drop the new keepers and everything they suppress
        suppressed = np.zeros(n, bool)
        sel = newkeep[a]
        suppressed[b[sel]] = True
        undecided &= ~(newkeep | suppressed)
        if not undecided.any():
            break
        live = undecided[a] & undecided[b]
        a, b = a[live], b[live]
        if len(a) == 0:
            kept |= undecided
            break
    return kept


def block_assigned_mask(q_from, bb, max_dist=60.0):
    """MaxDistCP.m only assigns distances to 'from' points inside the
    BB-anchored MaxDist block tiling [BB(1,:) , BB(1,:)+(Range+1)*MaxDist)
    with Range = floor((BB(2,:)-BB(1,:))/MaxDist) — anything outside keeps
    the 60 mm default and is later discarded by the 20 mm cut.  Replicate
    that exclusion exactly (MaxDistCP.m:3-18)."""
    rng_ = np.floor((bb[1] - bb[0]) / max_dist)
    hi = bb[0] + (rng_ + 1) * max_dist
    return ((q_from >= bb[0]) & (q_from < hi)).all(axis=1)


def _chamfer(q_from, q_to, bb, max_dist=60.0):
    """Distance from each q_from point to the nearest q_to point
    (MaxDistCP.m semantics): exact within the BB block tiling, the 60 mm
    default for q_from points outside it or with no q_to point in the
    ±60 mm block neighbourhood."""
    d = np.full(len(q_from), max_dist, np.float64)
    assigned = block_assigned_mask(q_from, bb, max_dist)
    if len(q_to) and assigned.any():
        tree = cKDTree(q_to)
        dd, _ = tree.query(q_from[assigned], k=1,
                           distance_upper_bound=max_dist, workers=-1)
        d[assigned] = np.minimum(dd, max_dist)
    return d


@dataclasses.dataclass
class ScanResult:
    acc_mean: float
    comp_mean: float
    acc_median: float
    comp_median: float
    n_data: int
    n_stl: int
    # per-point artifacts (BaseEval struct fields the MATLAB helpers
    # consume, BaseEvalMain_web.m / BaseEval2Obj_web.m) — populated only
    # when evaluate_scan(..., return_artifacts=True)
    q_data: np.ndarray | None = None      # (N,3) reduced method cloud
    d_data: np.ndarray | None = None      # (N,) accuracy distances
    data_in_mask: np.ndarray | None = None  # (N,) bool ObsMask membership
    q_stl: np.ndarray | None = None       # (M,3) STL ground truth
    d_stl: np.ndarray | None = None       # (M,) completeness distances
    stl_above_plane: np.ndarray | None = None  # (M,) bool


def evaluate_scan(method_pts, stl_pts, obs_mask, bb, res, ground_plane,
                  dst=0.2, max_dist=20.0, seed=0, prereduced=False,
                  return_artifacts=False):
    """Evaluate one scan.

    method_pts: (N,3) fused cloud; stl_pts: (M,3) structured-light GT
    (already 0.2mm-reduced, as shipped); obs_mask: 3-D bool voxel grid;
    bb: (2,3) bounding box [min;max]; res: voxel size; ground_plane: (4,)
    plane coefficients (P'*[x;1] > 0 means 'used').
    return_artifacts: keep the per-point distance/mask arrays on the
    result (the BaseEval struct fields) for OBJ export / inspection.
    """
    if not prereduced:
        method_pts = method_pts[reduce_pts(method_pts, dst, seed)]

    d_data = _chamfer(method_pts, stl_pts, bb)      # accuracy distances
    d_stl = _chamfer(stl_pts, method_pts, bb)       # completeness distances

    # ObsMask voxel lookup (PointCompareMain.m:36-44, 1-based rounding)
    qv = np.round((method_pts - bb[0]) / res + 1).astype(np.int64)
    shape = obs_mask.shape
    in_grid = ((qv[:, 0] > 0) & (qv[:, 0] <= shape[0])
               & (qv[:, 1] > 0) & (qv[:, 1] <= shape[1])
               & (qv[:, 2] > 0) & (qv[:, 2] <= shape[2]))
    data_in_mask = np.zeros(len(method_pts), bool)
    gi = qv[in_grid] - 1
    data_in_mask[in_grid] = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]] != 0

    above = (stl_pts @ ground_plane[:3] + ground_plane[3]) > 0

    fd = d_data[data_in_mask]
    fd = fd[fd < max_dist]
    fs = d_stl[above]
    fs = fs[fs < max_dist]

    result = ScanResult(
        acc_mean=float(fd.mean()) if len(fd) else float("nan"),
        comp_mean=float(fs.mean()) if len(fs) else float("nan"),
        acc_median=float(np.median(fd)) if len(fd) else float("nan"),
        comp_median=float(np.median(fs)) if len(fs) else float("nan"),
        n_data=len(fd), n_stl=len(fs))
    if return_artifacts:
        result.q_data = method_pts
        result.d_data = d_data
        result.data_in_mask = data_in_mask
        result.q_stl = stl_pts
        result.d_stl = d_stl
        result.stl_above_plane = above
    return result


def export_error_obj(result, method_string, scan_id, outdir,
                     dist_threshold=10.0):
    """Error-coloured OBJ export — the Python replacement for
    BaseEval2Obj_web.m: in-analysis points colour red→white over
    0..dist_threshold mm error; excluded points (outside ObsMask / below
    the ground plane) colour green→blue.  Writes
    <method>2Stl_<scan>.obj (accuracy) and Stl2<method>_<scan>.obj
    (completeness); returns the two paths.

    result: a ScanResult from evaluate_scan(..., return_artifacts=True).
    """
    import os
    if result.q_data is None:
        raise ValueError("evaluate_scan must be called with "
                         "return_artifacts=True to export OBJs")
    os.makedirs(outdir, exist_ok=True)

    def write(path, pts, dists, included):
        alpha = np.minimum(dists, dist_threshold) / dist_threshold
        # included: red*(a) + white*(1-a); excluded: green*(a) + blue*(1-a)
        cols = np.where(
            included[:, None],
            np.stack([np.ones_like(alpha), 1 - alpha, 1 - alpha], 1),
            np.stack([np.zeros_like(alpha), alpha, 1 - alpha], 1))
        with open(path, "w") as f:
            for (x, y, z), (r, g, b) in zip(pts, cols):
                f.write(f"v {x:f} {y:f} {z:f} {r:f} {g:f} {b:f}\n")

    acc_path = os.path.join(outdir, f"{method_string}2Stl_{scan_id}.obj")
    comp_path = os.path.join(outdir, f"Stl2{method_string}_{scan_id}.obj")
    write(acc_path, result.q_data, result.d_data, result.data_in_mask)
    write(comp_path, result.q_stl, result.d_stl, result.stl_above_plane)
    return acc_path, comp_path


def aggregate(results):
    """overall = (mean acc + mean comp) / 2 over scans."""
    acc = float(np.mean([r.acc_mean for r in results]))
    comp = float(np.mean([r.comp_mean for r in results]))
    return {"mean_acc_mm": acc, "mean_comp_mm": comp,
            "overall_mm": (acc + comp) / 2.0}


def load_obs_mask(path):
    """Read ObsMaskN_10.mat -> (obs_mask, bb, res)."""
    import scipy.io
    m = scipy.io.loadmat(path)
    return np.asarray(m["ObsMask"]), np.asarray(m["BB"], np.float64), \
        float(np.asarray(m["Res"]).squeeze())


def load_plane(path):
    import scipy.io
    m = scipy.io.loadmat(path)
    return np.asarray(m["P"], np.float64).reshape(-1)
