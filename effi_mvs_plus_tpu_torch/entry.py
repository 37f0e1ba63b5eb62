"""The port's compile-check entry points, the counterparts of the JAX
package's ``__graft_entry__.entry`` and ``dryrun_multichip``.

    from effi_mvs_plus_tpu_torch import entry
    fn, args = entry.entry()              # the forward on the card
    depth = fn(*args)                     # (1, 64, 96) final depth map
    entry.dryrun_multichip(2)             # the gate in two ranks

``entry`` runs the port's forward, eval mode and no gradients, at the
size of the JAX entry's inputs (1 x 3 views x 64 x 96, 384 inverse-depth
samples from the gate's seeded rig, ``parallel.equivalence.rig``) and
returns the final depth map, as the JAX entry's ``fn`` does.
``dryrun_multichip(n)`` runs the equivalence gate
(``parallel/equivalence.py``) in ``n`` processes as the JAX function
lays out its mesh: 2 model ranks where ``n`` is even (else 1) and
``n / model`` data ranks, a batch of one sample a data rank; one
training step under ``views,depth`` and, with two model ranks, one under
``spatial``, each from the same weights, batch and random stream as one
process's step, held to the JAX bounds (|Δloss| <= 1e-4 (1 + |loss|),
max |Δparam| <= 2.5e-3 after the AdamW step).  Both run on ``cuda``
unless the caller passes ``device="cpu"``, and raise without a GPU;
ranks that outnumber the host's GPUs share them over gloo (NCCL takes one
rank a GPU).
"""

from __future__ import annotations

import tempfile

import torch

from effi_mvs_plus_tpu_torch.device import resolve_device
from effi_mvs_plus_tpu_torch.models import EffiMVS, EffiMVSConfig
from effi_mvs_plus_tpu_torch.parallel import equivalence as E

# the JAX entry's inputs: batch, views, height, width
SHAPE = (1, 3, 64, 96)


def _seeded_state(cfg, seed=0):
    """The network's torch-default initialisation drawn from ``seed``."""
    torch.manual_seed(seed)
    return EffiMVS(cfg).state_dict()


def entry(device=None, state_dict=None):
    """(fn, example_args): ``fn(imgs, proj_stage1, proj_stage2,
    proj_stage3, depth_values)`` is the forward (eval mode, no gradients)
    returning the final depth map (B, H, W); its weights are
    ``state_dict`` (loaded strictly) or seeded.  The arguments are the
    JAX entry's inputs as tensors on the device."""
    dev = resolve_device(device)
    cfg = EffiMVSConfig()
    model = EffiMVS(cfg)
    model.load_state_dict(state_dict if state_dict is not None
                          else _seeded_state(cfg), strict=True)
    model.to(dev).eval()
    imgs, proj_ms, dv = E.rig(*SHAPE)

    def fn(imgs, proj_stage1, proj_stage2, proj_stage3, depth_values):
        with torch.no_grad():
            out = model(imgs, {"stage1": proj_stage1, "stage2": proj_stage2,
                               "stage3": proj_stage3}, depth_values)
        return out["depth"][-1]

    example_args = tuple(torch.from_numpy(a).to(dev) for a in (
        imgs, proj_ms["stage1"], proj_ms["stage2"], proj_ms["stage3"], dv))
    return fn, example_args


def dryrun_multichip(n, device=None, timeout=600.0):
    """The gate in ``n`` processes on ``device`` (see the module's text);
    prints one line a layout and returns the readings.  A reading past
    the JAX bounds raises AssertionError."""
    dev = resolve_device(device)
    model = 2 if n % 2 == 0 and n >= 2 else 1
    data = n // model
    cfg = EffiMVSConfig()
    layouts = {"views,depth": (data, model, "views,depth")}
    if model > 1:
        layouts["spatial"] = (data, model, "spatial")
    ref = E.references(_seeded_state(cfg), cfg, E.train_batch(B=data),
                       dev.type)
    shared = dev.type == "cuda" and torch.cuda.device_count() < n
    with tempfile.TemporaryDirectory() as work:
        report = E.spawn(n, list(layouts), ref, work, device=dev.type,
                         backend="gloo" if shared else None,
                         timeout=timeout, check=False, specs=layouts)
    ref_loss = ref["step"][0]
    for tag in layouts:
        r = report[tag]
        if not abs(r["dloss"]) <= E.LOSS_RTOL * (1 + abs(ref_loss)):
            raise AssertionError(f"{tag}: loss {r['loss']} != single "
                                 f"process {ref_loss}")
        if not r["max_dparam"] <= E.PARAM_ATOL:
            raise AssertionError(f"{tag}: updated parameters diverge "
                                 f"(max |Δ| {r['max_dparam']:.3e})")
        print(f"dryrun_multichip({n}): mesh data={data} model={model} "
              f"{tag} loss={r['loss']:.4f} sharded == single process "
              f"(Δloss {r['dloss']:.2e}, max |Δparam| "
              f"{r['max_dparam']:.2e}) OK", flush=True)
    return report
