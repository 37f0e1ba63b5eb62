"""Faults planted in the data-parallel equivalence gate, and a witness for
its worst gradient leaf.

    python3 scripts/torch_gate_faults.py                 # CPU, about 1 min
    python3 scripts/torch_gate_faults.py --device cuda   # one GPU, ~3 min

The gate (``effi_mvs_plus_tpu_torch/parallel/equivalence.py``) holds a
data-parallel step (data 2 x model 1, two spawned ranks) to the single
process: |Δloss| <= 1e-4 (1 + |loss|), max |Δ| <= 2.5e-3 over the state
after one AdamW step, every gradient leaf within rel-l2 5e-2.  This
script reads the gate on the clean port and with each of three faults
planted in the ranks (the single process stays clean):

* ``bn_local``      — train-mode BN normalises each rank's rows with that
                      rank's own statistics (no all_reduce of the sums);
* ``dropout_local`` — each rank draws a dropout mask for its own rows only
                      from the shared-seed generator (so every rank gets the
                      first rows' mask);
* ``loss_local``    — each rank's masked means divide by its own count.

Then two witnesses for the clean gate's worst gradient leaf: the single
process again on images one fp32 ulp up (how far an fp32-sized change of
the inputs moves each leaf), and the single process with its BN
statistics and loss sums in float64, against which both the fp32 single
process and the fp32 data-parallel step are read (whether the rounding
of those sums is what moves the leaf).

On the CPU the step is the gate of ``tests/test_torch_parallel.py``
(``model_dtu.npz``, B=2, 3 views, 64x96, gloo); on ``cuda`` it is
``chip_smoke.py``'s distributed step (the blend_finetune config, B=8,
7 views, 768x576, on its rendered BlendedMVS tree; two ranks on the one
card with gloo on CUDA tensors).  Prints one JSON line per case and, with
``--out``, writes them all to a file.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from effi_mvs_plus_tpu_torch.parallel import equivalence as E  # noqa: E402
from effi_mvs_plus_tpu_torch.parallel import mesh  # noqa: E402


class _Hooks:
    """The mesh module's hooks as a module sees them, some replaced."""

    def __init__(self, **replaced):
        self.replaced = replaced

    def __getattr__(self, name):
        return self.replaced.get(name) or getattr(mesh, name)


def bn_local():
    from effi_mvs_plus_tpu_torch import nn
    nn.par = _Hooks(reduce_data=lambda x: x, data_parallel=lambda: 1)


def dropout_local():
    from effi_mvs_plus_tpu_torch import nn
    nn.par = _Hooks(dropout_rows=lambda n: (n, 0))


def loss_local():
    from effi_mvs_plus_tpu_torch.train import loss
    loss.par = _Hooks(reduce_data=lambda x: x)


FAULTS = {"bn_local": bn_local, "dropout_local": dropout_local,
          "loss_local": loss_local}


@contextlib.contextmanager
def fp64_statistics():
    """Train-mode BN statistics (and the normalisation they feed) and the
    loss's masked sums in float64, in this process."""
    from effi_mvs_plus_tpu_torch import nn
    from effi_mvs_plus_tpu_torch.train import loss
    bn, mm = nn.batch_norm, loss.masked_mean

    def bn64(x, b, groups=1):
        if not b.training:
            return bn(x, b, groups)
        return bn(x.double(), b, groups).to(x.dtype)
    nn.batch_norm = bn64
    loss.masked_mean = lambda v, m: mm(v.double(), m).to(v.dtype)
    try:
        yield
    finally:
        nn.batch_norm, loss.masked_mean = bn, mm


def caught_by(ref_loss, d):
    why = []
    if not d["dloss"] <= E.LOSS_RTOL * (1 + abs(ref_loss)):
        why.append("dloss")
    if not d["max_dparam"] <= E.PARAM_ATOL:
        why.append("max_dparam")
    if not d["grad_worst_rel_l2"] < E.GRAD_REL:
        why.append("grad_rel_l2")
    return why


def inputs(device, work):
    """(state, config, global batch, description) of the step."""
    from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint
    from effi_mvs_plus_tpu_torch.models import EffiMVSConfig
    if device == "cpu":
        sd = load_npz_checkpoint(os.path.join(ROOT, "checkpoints",
                                              "model_dtu.npz"))
        return (sd, EffiMVSConfig(), E.train_batch(),
                "tests/test_torch_parallel.py gate: dtu B2 V3 64x96 fp32")
    import chip_smoke as C
    from effi_mvs_plus_tpu_torch.data import cams as camio
    from effi_mvs_plus_tpu_torch.device import resolve_device
    resolve_device("cuda")
    listfile = C.render_blend_tree(torch, work, camio)
    sd = load_npz_checkpoint(os.path.join(ROOT, "checkpoints",
                                          "model_dtu.npz"))
    return (sd, EffiMVSConfig(ndepths=C.BLEND["ndepths"]),
            C.blend_batch(work, listfile),
            "chip_smoke.py distributed step: blend_finetune B8 V7 "
            "768x576 96/8/8 fp32")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a GPU")
    torch.set_num_threads(2 if cpu else 8)
    kw = dict(device=args.device, backend="gloo", check=False,
              timeout=120 if cpu else 600, threads=2 if cpu else 4)
    lines = []

    def emit(obj):
        if not cpu:
            import chip_smoke as C
            obj["card"] = C.nvidia_smi()
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    with tempfile.TemporaryDirectory() as work:
        sd, cfg, batch, what = inputs(args.device, work)
        ref = E.references(sd, cfg, batch, args.device)
        if not cpu:
            torch.cuda.empty_cache()
        ref_loss = ref["step"][0]
        gate = E.spawn(2, ["data"], ref, work, **kw)["data"]
        leaf = gate["grad_worst_leaf"]

        def reading(case, d, against="single process, fp32"):
            out = {"case": case, "step": what, "against": against,
                   "loss": d["loss"], "dloss": d["dloss"],
                   "dloss_bound": E.LOSS_RTOL * (1 + abs(ref_loss)),
                   "max_dparam": d["max_dparam"],
                   "grad_worst_rel_l2": d["grad_worst_rel_l2"],
                   "grad_worst_leaf": d["grad_worst_leaf"],
                   "gate_leaf": leaf,
                   "gate_leaf_rel_l2": d["grad_rel_l2"][leaf],
                   "caught_by": caught_by(ref_loss, d)}
            emit(out)
        reading("gate (clean)", gate)
        for name, plant in FAULTS.items():
            got = E.spawn(2, ["data"], ref, work, setup=plant, **kw)["data"]
            reading(f"fault {name}", got)
        up = dict(batch, imgs=np.nextafter(np.asarray(batch["imgs"]),
                                           np.float32(np.inf)))
        reading("witness: single process fp32, images one ulp up",
                E.step_deltas(ref["step"], E.train_step(sd, cfg, up,
                                                        args.device)))
        with fp64_statistics():
            ref64 = E.references(sd, cfg, batch, args.device)
        if not cpu:
            torch.cuda.empty_cache()
        against = "single process, BN statistics and loss sums in float64"
        reading("witness: single process fp32",
                E.step_deltas(ref64["step"], ref["step"]), against)
        reading("witness: data-parallel fp32",
                E.spawn(2, ["data"], ref64, work, **kw)["data"], against)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")


if __name__ == "__main__":
    main()
