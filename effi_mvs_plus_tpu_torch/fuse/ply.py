"""Minimal binary PLY codec, the port's copy of
``effi_mvs_plus_tpu/fuse/ply.py``.

Writes the layout the reference produces through `plyfile`:
binary_little_endian vertices with float32 x,y,z and uchar
red,green,blue, byte for byte what the JAX package writes.  ``write_ply``
writes through the native data plane (``native.ply_write``), as the JAX
writer does; a failed build raises (the port's rule for ``native/``).
``write_ply_numpy`` is its plain version, the same bytes from numpy.
"""

from __future__ import annotations

import numpy as np

_VERTEX_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                          ("red", "u1"), ("green", "u1"), ("blue", "u1")])


def _points(xyz, rgb):
    xyz = np.asarray(xyz, dtype=np.float32)
    if rgb is None:
        rgb = np.full((len(xyz), 3), 255, np.uint8)
    return xyz, np.asarray(rgb, dtype=np.uint8)


def write_ply(path, xyz, rgb=None):
    """xyz: (N,3) float; rgb: (N,3) uint8 or None (defaults to white)."""
    from effi_mvs_plus_tpu_torch import native
    native.ply_write(path, *_points(xyz, rgb))


def write_ply_numpy(path, xyz, rgb=None):
    """``write_ply``'s file, written by numpy."""
    xyz, rgb = _points(xyz, rgb)
    n = len(xyz)
    rec = np.empty(n, dtype=_VERTEX_DTYPE)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path):
    """Reads binary or ascii PLY vertices; returns (xyz (N,3) float32,
    rgb (N,3) uint8 or None).  Supports the subset this framework and the
    DTU ground-truth files use (x,y,z [+colors] vertex properties)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element"):
                in_vertex = False   # later elements (faces): vertices only
            elif line.startswith(b"property") and in_vertex \
                    and not props_done(props, line):
                toks = line.split()
                props.append((toks[-1].decode(), toks[1].decode()))
            elif line == b"end_header":
                break

        typemap = {"float": "<f4", "float32": "<f4", "double": "<f8",
                   "uchar": "u1", "uint8": "u1", "int": "<i4",
                   "uint": "<u4", "short": "<i2", "ushort": "<u2"}
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            names = [p[0] for p in props]
            xyz = data[:, [names.index(c) for c in "xyz"]].astype(np.float32)
            rgb = None
            if "red" in names:
                rgb = data[:, [names.index(c)
                               for c in ("red", "green", "blue")]]
                rgb = rgb.astype(np.uint8)
            return xyz, rgb
        dtype = np.dtype([(name, typemap[t]) for name, t in props])
        rec = np.fromfile(f, dtype=dtype, count=n)
        if fmt == "binary_big_endian":
            rec = rec.byteswap()
        xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
        rgb = None
        if "red" in dtype.names:
            rgb = np.stack([rec["red"], rec["green"], rec["blue"]],
                           -1).astype(np.uint8)
        return xyz, rgb


def props_done(props, line):
    """Stop collecting vertex properties once list-type props appear
    (face elements)."""
    return b"list" in line
