#!/usr/bin/env python3
"""How far the port's bf16 forward departs from the JAX package's, on the
CPU.

    JAX_PLATFORMS=cpu python3 scripts/diag_torch_bf16.py

A diagnostic beside ``tests/test_torch_bf16.py``: it imports both
packages, as the tests do.  On the seeded 96x128, V=3 scene of
``tests/test_torch_model.py`` with ``checkpoints/model_dtu.npz`` it prints
one JSON line per depth map: the max and the median abs error (mm) of
port-bf16 against JAX-bf16, of JAX-bf16 against JAX-fp32 and of port-bf16
against port-fp32, and of JAX-bf16 against JAX-bf16 on the same images with one pixel value raised by one bf16 ulp (how chaotic the bf16
forward is on these inputs).
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
                                            build_model)
from test_torch_model import CKPT, make_inputs, run_jax, run_port  # noqa: E402


def main():
    imgs, proj_ms, dv = make_inputs()
    params = jax_load(CKPT["dtu"])
    sd = load_npz_checkpoint(CKPT["dtu"])
    port16, _ = run_port(build_model(
        sd, EffiMVSConfig(compute_dtype=torch.bfloat16), device="cpu"),
        imgs, proj_ms, dv)
    port32, _ = run_port(build_model(sd, EffiMVSConfig(), device="cpu"),
                         imgs, proj_ms, dv)
    jax16, _ = run_jax(params, JaxConfig(compute_dtype=jnp.bfloat16), imgs,
                       proj_ms, dv)
    jax32, _ = run_jax(params, JaxConfig(), imgs, proj_ms, dv)
    nudged = imgs.copy()
    v = float(jnp.asarray(nudged[0, 0, 40, 60, 1]).astype(jnp.bfloat16))
    nudged[0, 0, 40, 60, 1] = v * (1 + 2.0 ** -7)     # one bf16 ulp up
    jax16n, _ = run_jax(params, JaxConfig(compute_dtype=jnp.bfloat16),
                        nudged, proj_ms, dv)
    for i in range(len(jax32)):
        line = {"map": i}
        for name, a, b in (("port_bf16_vs_jax_bf16", port16, jax16),
                           ("jax_bf16_vs_jax_fp32", jax16, jax32),
                           ("port_bf16_vs_port_fp32", port16, port32)):
            d = np.abs(a[i] - b[i])
            line[name + "_mm"] = float(d.max())
            line[name + "_median_mm"] = float(np.median(d))
        d = np.abs(jax16n[i] - jax16[i])
        print(json.dumps({
            **line, "jax_bf16_one_ulp_nudge_mm": float(d.max()),
            "jax_bf16_one_ulp_nudge_median_mm": float(np.median(d)),
            "map_range_mm": float(jax32[i].max() - jax32[i].min())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
