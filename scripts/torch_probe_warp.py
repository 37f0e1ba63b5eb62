"""The warp + correlation K1 and its backward K3 alone on the card.

    python scripts/torch_probe_warp.py [--only k1|k3]
    python scripts/torch_probe_warp.py --ab DIR [--only k1|k3]
    python scripts/torch_probe_warp.py --ablate nostage|onewindow|fastdiv

The first form builds the kernels (printing nvcc's register, shared-memory
and spill report) and runs ``chip_smoke.py``'s own K1 and K3 phases: every
stage shape of the DTU eval, T&T and DTU training configs (K1) and of the
training and DTU configs (K3), fp32 and bf16, held against the plain
versions with chip_smoke.py's checks (K3 also on its off-image and
behind-camera rigs), one JSON line a case with the kernel's time, its
window share and, for K3, the adds that reach device memory.

The second form times the kernels of another checkout of the repository,
DIR (for instance the parent commit unpacked under ``build/`` with
``git archive``), against this one's in the same call, in turns: DIR,
this, this, DIR, each in a process of its own that builds its kernels and
times every shape on the same seeded inputs (``--time ROOT``, one JSON
line a case); then one line a shape with both medians and the ratio.

The third times K1's windowed kernel at the stage-1 shapes against a copy
of this checkout (under ``build/ablate/``) with one cost taken out, in
the same turns: ``nostage`` stages no window (the kernel reads whatever
shared memory holds), ``onewindow`` finds and stages a block's first
window only and serves every later chunk from it (no window search,
barriers or copies after the first), ``fastdiv`` replaces the
projection's two IEEE divisions by approximate ones.  The copies compute
wrong results; only their times count, as the share of K1's time that
cost takes.

Needs a CUDA GPU and nvcc.  Its inputs come from a fresh generator, so
they are not the ones chip_smoke.py draws.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"k1": ("dtu", "tnt", "train"), "k3": ("train", "dtu")}
# K1 ablations: file under csrc/, and (text, its replacement) pairs
ABLATIONS = {
    "nostage": ("warp_correlate.cu", (
        ("for (int u = threadIdx.x; u < n; u += TILE_N) {",
         "for (int u = threadIdx.x; u < 0; u += TILE_N) {"),)),
    "onewindow": ("warp_correlate.cu", (
        ("    const int cur = i & 1;\n    if (i + 1 < items) {",
         "    const int cur = 0;\n    if (false) {"),)),
    "fastdiv": ("warp_project.cuh", (
        ("px = X / Z;\n  py = Y / Z;",
         "px = __fdividef(X, Z);\n  py = __fdividef(Y, Z);"),)),
}


def check_phases(only):
    """chip_smoke.py's K1 and K3 phases, from this checkout."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.ops import _kernels
    resolve_device("cuda")
    _kernels.build(verbose=True)
    _kernels.library()
    print(chip_smoke.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    if only != "k3":
        with torch.inference_mode():
            for cname in SHAPES["k1"]:
                cfg = chip_smoke.TRAIN if cname == "train" \
                    else chip_smoke.CONFIGS[cname]
                proj_ms, dv = chip_smoke.rig(cfg, camio)
                for s in range(3):
                    for dtype in (torch.float32, torch.bfloat16):
                        chip_smoke.log({"phase": "kernels",
                                        **chip_smoke.warp_entry(
                                            torch, gen, cname, cfg, proj_ms,
                                            dv, s, str(dtype)[6:], dtype)})
                torch.cuda.empty_cache()
    if only != "k1":
        chip_smoke.bwd_kernel_phases(torch, gen)


def time_root(root, only, reps, stages):
    """Median ms of K1 and K3 of the checkout at ``root`` at every shape
    of the given stages (1-3), on inputs from a generator seeded as
    chip_smoke.py seeds its own."""
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    from effi_mvs_plus_tpu_torch.core import geometry
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.device import resolve_device
    from effi_mvs_plus_tpu_torch.ops import _kernels, cuda_warp
    resolve_device("cuda")
    _kernels.library()
    kernels = [k for k in ("k1", "k3") if only in (None, k)]
    for kernel in kernels:
        for cname in SHAPES[kernel]:
            cfg = chip_smoke.TRAIN if cname == "train" \
                else chip_smoke.CONFIGS[cname]
            proj_ms, dv = chip_smoke.rig(cfg, camio)
            for s in (int(c) - 1 for c in stages):
                for dtype in (torch.float32, torch.bfloat16):
                    gen = torch.Generator(device="cuda").manual_seed(
                        chip_smoke.SEED + s)
                    ref, src, rots, trs, depth = chip_smoke.stage_inputs(
                        torch, geometry, cfg, proj_ms, dv, s, dtype, gen)
                    if kernel == "k1":
                        def fn():
                            return cuda_warp.warp_correlate_views(
                                ref, src, rots, trs, depth)
                    else:
                        g = torch.randn((*src.shape[:2], depth.shape[1],
                                         *ref.shape[1:3]), generator=gen,
                                        device="cuda").to(dtype)

                        def fn():
                            return cuda_warp._views_bwd_cuda(
                                ref, src, rots, trs, depth, g)
                    with torch.inference_mode():
                        ms = chip_smoke.median_ms(torch, fn, reps)
                    print(json.dumps({"kernel": kernel, "config": cname,
                                      "stage": s + 1,
                                      "dtype": str(dtype)[6:], "ms": ms}),
                          flush=True)
            torch.cuda.empty_cache()


def ab(other, only, reps, stages="123"):
    """Time ``other`` and this checkout in turns: other, this, this,
    other; print each shape's medians and the ratio other / this."""
    runs = {}
    for root in (other, ROOT, ROOT, other):
        cmd = [sys.executable, os.path.abspath(__file__), "--time", root,
               "--reps", str(reps), "--stages", stages] \
            + (["--only", only] if only else [])
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"timing {root} failed")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                key = (r["kernel"], r["config"], r["stage"], r["dtype"])
                runs.setdefault(key, {}).setdefault(
                    "this" if root == ROOT else "other", []).append(r["ms"])
    for key, t in runs.items():
        print(json.dumps({"kernel": key[0], "config": key[1],
                          "stage": key[2], "dtype": key[3],
                          "other_ms": t["other"], "this_ms": t["this"],
                          "speedup": statistics.median(t["other"])
                          / statistics.median(t["this"])}), flush=True)


def ablate(name, reps):
    """K1 at the stage-1 shapes: this checkout against a copy with
    ablation ``name`` applied, in turns (``ab``)."""
    fname, edits = ABLATIONS[name]
    dst = os.path.join(ROOT, "build", "ablate", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "effi_mvs_plus_tpu_torch"),
                    os.path.join(dst, "effi_mvs_plus_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, "effi_mvs_plus_tpu_torch", "csrc", fname)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation {name}: {fname} has no single "
                             f"{old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    ab(dst, "k1", reps, "1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("k1", "k3"))
    ap.add_argument("--ab", metavar="DIR",
                    help="another checkout to time against this one")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS),
                    help="time K1 at stage 1 with one cost taken out")
    ap.add_argument("--time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--stages", default="123", help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    if args.time:
        time_root(os.path.abspath(args.time), args.only, args.reps,
                  args.stages)
    elif args.ablate:
        ablate(args.ablate, args.reps)
    elif args.ab:
        ab(os.path.abspath(args.ab), args.only, args.reps)
    else:
        check_phases(args.only)


if __name__ == "__main__":
    main()
