#!/usr/bin/env python3
"""How far the fused FPN stem (BN folded, one chain a level) moves the
bf16 forward, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/diag_torch_fused_stem_bf16.py

A diagnostic beside ``tests/test_torch_bf16.py``: it imports both
packages, as the tests do, and runs the port's fused branch on the CPU by
patching ``models.blocks.stem_chain_applies`` (the model fuses on the card
only).  On the seeded 96x128, V=3 scene of ``tests/test_torch_model.py``
with ``checkpoints/model_dtu.npz`` it prints one JSON line per depth map:
the max abs error (mm) of the port's fused bf16 forward against JAX's
bf16 forward with its XLA stem (what the test compares with) and with its
pallas stem, of JAX's pallas stem against its XLA stem, and the test's
bound (30% of the sweep's depth range).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from effi_mvs_plus_tpu.io import load_npz_checkpoint as jax_load  # noqa: E402
from effi_mvs_plus_tpu.models import EffiMVSConfig as JaxConfig  # noqa: E402
from effi_mvs_plus_tpu_torch.io import load_npz_checkpoint  # noqa: E402
from effi_mvs_plus_tpu_torch.models import (EffiMVSConfig,  # noqa: E402
                                            blocks, build_model)
from test_torch_model import CKPT, make_inputs, run_jax, run_port  # noqa: E402


def main():
    imgs, proj_ms, dv = make_inputs()
    params = jax_load(CKPT["dtu"])
    blocks.stem_chain_applies = lambda x, training: not (
        training or torch.is_grad_enabled())
    fused, _ = run_port(build_model(
        load_npz_checkpoint(CKPT["dtu"]),
        EffiMVSConfig(compute_dtype=torch.bfloat16), device="cpu"),
        imgs, proj_ms, dv)
    xla, _ = run_jax(params, JaxConfig(compute_dtype=jnp.bfloat16), imgs,
                     proj_ms, dv)
    pallas, _ = run_jax(params, JaxConfig(compute_dtype=jnp.bfloat16,
                                          stem_impl="pallas"),
                        imgs, proj_ms, dv)
    bound = 0.3 * (1.0 / dv[0, 0] - 1.0 / dv[0, -1])
    for i, (f, x, p) in enumerate(zip(fused, xla, pallas)):
        print(json.dumps({
            "map": i, "bound_mm": float(bound),
            "fused_vs_jax_xla_mm": float(np.abs(f - x).max()),
            "fused_vs_jax_pallas_mm": float(np.abs(f - p).max()),
            "jax_pallas_vs_jax_xla_mm": float(np.abs(p - x).max())}),
            flush=True)


if __name__ == "__main__":
    main()
