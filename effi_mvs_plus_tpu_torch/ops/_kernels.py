"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all of
them at once in parallel, and the objects are linked into one shared
library with a plain C interface that ``ctypes`` loads.  The library goes
under ``build/cuda_kernels/<hash>/`` at the root of the checkout (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree loads what is there.  Nothing is built at
import: ``library()`` builds on first use, which is the first launch of
a kernel or an explicit ``build()``.

Every wrapper launches through ``launch``: the device guard, the call on
the current stream, the status check and the kernel's counter; the
wrappers keep their own shape and argument checks, with ``check_dtype``
and ``check_dense`` for what every kernel asks of its tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from effi_mvs_plus_tpu_torch.utils import profiling

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SOURCES = ("warp_correlate.cu", "warp_correlate_bwd.cu", "conv_gru.cu",
           "conv_chain.cu", "conv3d_reg.cu")
HEADERS = ("warp_project.cuh", "warp_window.cuh", "conv3x3_tile.cuh")
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "cuda_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")
LIB_NAME = "libeffi_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types (csrc/*.cu, extern "C")
SIGNATURES = {
    "effi_warp_correlate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _L, _L, _L, _L, _L, _L, _I, _I, _P, _I,
                            _P],
    "effi_warp_correlate_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                                _L, _I, _I, _P, _I, _P],
    "effi_conv_gru": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "effi_conv_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "effi_conv3d_reg": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# each entry's launch counter (utils/profiling.py)
COUNTERS = {"warp_correlate": "k1.launches",
            "warp_correlate_bwd": "k3.launches", "conv_gru": "k2.launches",
            "conv_chain": "k4.launches", "conv3d_reg": "conv3d_reg.launches"}
# the dtype code each entry takes before its stream
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose=False) -> tuple[Path, float]:
    """Compile the sources (one nvcc each, all started together) and link
    them into one library.  Returns (library path, build seconds); a
    library already built from the same sources is reused (0 seconds)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, _, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            if verbose and log:
                print(f"nvcc {name}:\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *(str(o) for _, o, _ in procs),
             "-o", str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, lib)      # atomic: a concurrent build is harmless
    return lib, time.perf_counter() - t0


_built_s = None     # the seconds library() spent in build()


def build_seconds() -> float | None:
    """The seconds ``library()`` spent building the library in this
    process: 0.0 where it found the library built, None before its first
    call.  On a fresh checkout this is the nvcc share of the first run's
    set-up."""
    return _built_s


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _built_s
    path, _built_s = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_dtype(**tensors):
    """Raise ValueError unless the named tensors share one of ``DTYPES``."""
    first, *rest = tensors.values()
    if first.dtype not in DTYPES or any(t.dtype != first.dtype for t in rest):
        got = " / ".join(str(t.dtype) for t in tensors.values())
        raise ValueError(f"{' and '.join(tensors)} must share one of "
                         f"{list(DTYPES)}, got {got}")


def _dense(t, n):
    """Whether the trailing ``n`` dims of t are dense (dims of one aside)."""
    want = 1
    for dim in range(t.dim() - 1, t.dim() - 1 - n, -1):
        if t.shape[dim] != 1 and t.stride(dim) != want:
            return False
        want *= t.shape[dim]
    return True


def check_dense(inner=None, **tensors):
    """Raise ValueError unless each named tensor (None skipped) can be read
    16 bytes at a time as the kernels read it: dense (with ``inner``, its
    trailing ``inner`` dims), its start 16-byte aligned and, with
    ``inner``, each step along dim 0 too (one batch item a block)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if not (t.is_contiguous() if inner is None else _dense(t, inner)):
            raise ValueError(f"{name} must be dense (contiguous) in "
                             f"{'all' if inner is None else inner} trailing "
                             f"dims, got strides {t.stride()}")
        if t.data_ptr() % 16 or (inner is not None and (
                t.stride(0) * t.element_size()) % 16):
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)"
                             f"{'' if inner is None else ' per batch item'}")


def launch(name, like, *args):
    """Launch the entry ``effi_<name>`` with ``args``, then the dtype code
    of ``like`` (a tensor the kernel reads) and the current stream of its
    device; raise RuntimeError on a nonzero cudaError_t, and add one to
    the entry's counter (``COUNTERS``)."""
    lib = library()
    with torch.cuda.device(like.device):
        status = getattr(lib, "effi_" + name)(
            *args, DTYPES[like.dtype],
            torch.cuda.current_stream(like.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")
    profiling.count(COUNTERS[name])
