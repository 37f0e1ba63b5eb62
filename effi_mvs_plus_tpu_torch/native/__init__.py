"""ctypes bindings of the port's native data plane (``src/effi_native.cc``):
PFM read and write, cv2-rule bilinear and nearest resize of float32
images, binary PLY writing.

The port of ``effi_mvs_plus_tpu/native/__init__.py``.  The library is
built with ``g++`` at first use into ``build/native/<hash>/`` at the root
of the checkout (listed in ``.gitignore``), keyed by a hash of the source
and flags, and nothing is built at import.  Unlike the JAX binding, which
falls back to numpy when the build fails, a failed build raises: these
functions are the native route, and the port's readers and writers keep
their numpy codecs and resizes (``data/pfm.py``,
``data/datasets._resize_bilinear``, ``fuse/ply.py``) as their own route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "effi_native.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")
LIB_NAME = "libeffi_native.so"

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int
# C entry points: (argument types, result type)
SIGNATURES = {
    "effi_pfm_header": ([ctypes.c_char_p, _I32P, _I32P, _I32P, _I32P,
                         ctypes.POINTER(ctypes.c_long), _F32P], _I),
    "effi_pfm_read": ([ctypes.c_char_p, _F32P], _I),
    "effi_pfm_write": ([ctypes.c_char_p, _F32P, _I, _I, _I,
                        ctypes.c_float], _I),
    "effi_resize_bilinear_f32": ([_F32P, _I, _I, _I, _F32P, _I, _I], None),
    "effi_resize_nearest_f32": ([_F32P, _I, _I, _I, _F32P, _I, _I], None),
    "effi_ply_write": ([ctypes.c_char_p, _F32P,
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long], _I),
}


def build() -> Path:
    """Compile the library unless one from the same source and flags is
    there; its path.  Raises RuntimeError with g++'s output on failure."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o",
                                   str(tmp_lib)], capture_output=True,
                                  text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native data plane "
                               "cannot be built") from e
        if proc.returncode != 0:
            raise RuntimeError("g++ failed to build the native data "
                               "plane\n" + proc.stdout + proc.stderr)
        os.replace(tmp_lib, lib)      # atomic: a concurrent build is harmless
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _fptr(a):
    return a.ctypes.data_as(_F32P)


def pfm_read(path):
    """(array (H,W) or (H,W,3) float32, scale) of a PFM file; raises
    OSError on a file it cannot parse."""
    lib = library()
    w, h, ch, little = (ctypes.c_int() for _ in range(4))
    off, scale = ctypes.c_long(), ctypes.c_float()
    p = os.fspath(path).encode()
    rc = lib.effi_pfm_header(p, ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(ch), ctypes.byref(little),
                             ctypes.byref(off), ctypes.byref(scale))
    if rc != 0:
        raise OSError(f"PFM header parse failed ({rc}): {path}")
    shape = (h.value, w.value, 3) if ch.value == 3 else (h.value, w.value)
    out = np.empty(shape, np.float32)
    rc = lib.effi_pfm_read(p, _fptr(out))
    if rc != 0:
        raise OSError(f"PFM read failed ({rc}): {path}")
    return out, float(scale.value)


def pfm_write(path, image, scale=1.0):
    """Write an (H,W), (H,W,1) or (H,W,3) image as a little-endian PFM."""
    img = np.ascontiguousarray(image, np.float32)
    if not (img.ndim == 2 or img.ndim == 3 and img.shape[2] in (1, 3)):
        raise ValueError(f"PFM takes (H,W), (H,W,1) or (H,W,3), got "
                         f"{img.shape}")
    ch = 3 if img.ndim == 3 and img.shape[2] == 3 else 1
    if ch == 1:
        img = img.reshape(img.shape[0], img.shape[1])
    rc = library().effi_pfm_write(os.fspath(path).encode(), _fptr(img),
                                  img.shape[1], img.shape[0], ch,
                                  float(scale))
    if rc != 0:
        raise OSError(f"PFM write failed ({rc}): {path}")


def resize(img, wh, nearest=False):
    """cv2.resize of a float32 (H,W) or (H,W,C) image to ``wh`` = (width,
    height), INTER_LINEAR (or INTER_NEAREST)."""
    src = np.ascontiguousarray(img, np.float32)
    if src.ndim not in (2, 3):
        raise ValueError(f"resize takes (H,W) or (H,W,C), got {src.shape}")
    dw, dh = (int(v) for v in wh)
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad target size {wh}")
    ch = 1 if src.ndim == 2 else src.shape[2]
    sh, sw = src.shape[:2]
    out = np.empty((dh, dw) if src.ndim == 2 else (dh, dw, ch), np.float32)
    lib = library()
    fn = lib.effi_resize_nearest_f32 if nearest else \
        lib.effi_resize_bilinear_f32
    fn(_fptr(src), sh, sw, ch, _fptr(out), dh, dw)
    return out


def ply_write(path, xyz, rgb=None):
    """Write (N,3) float32 points as a binary little-endian PLY: with
    (N,3) uint8 colours, byte for byte ``fuse/ply.write_ply``'s file;
    without, x/y/z alone (``write_ply`` writes them white)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"xyz must be (N, 3), got {xyz.shape}")
    colours = None
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.shape != xyz.shape:
            raise ValueError(f"rgb {rgb.shape} does not match xyz "
                             f"{xyz.shape}")
        colours = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = library().effi_ply_write(os.fspath(path).encode(), _fptr(xyz),
                                  colours, len(xyz))
    if rc != 0:
        raise OSError(f"PLY write failed ({rc}): {path}")
