"""The port's image grid (``effi_mvs_plus_tpu_torch/utils/logging.py``):
``_colorize`` byte for byte the JAX package's, and ``save_image_grid``'s
PNG the JAX package's."""

import numpy as np
import pytest
from PIL import Image

from effi_mvs_plus_tpu.utils import logging as jlog
from effi_mvs_plus_tpu_torch.utils import logging as tlog


def _depth(seed=0, H=20, W=28):
    rng = np.random.default_rng(seed)
    d = rng.uniform(400, 900, (H, W)).astype(np.float32)
    d[rng.uniform(0, 1, (H, W)) < 0.1] = np.inf     # not finite: invalid
    return d


@pytest.mark.parametrize("kw", [{}, {"vmin": 500.0, "vmax": 800.0},
                                {"mask": "half"}])
def test_colorize_matches_jax_byte_for_byte(kw):
    d = _depth()
    if kw.get("mask") == "half":
        kw = {"mask": (np.arange(d.size).reshape(d.shape) % 2).astype(
            np.float32)}
        d = np.where(np.isfinite(d), d, 0).astype(np.float32)
    got, want = tlog._colorize(d, **kw), jlog._colorize(d, **kw)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert (got == 0).all(-1).any() and (got > 0).any()


def test_save_image_grid_matches_jax(tmp_path):
    maps = {"depth": _depth(0), "conf": _depth(1, 10, 14)[..., :12]}
    p = tlog.save_image_grid(str(tmp_path / "a" / "port.png"), maps)
    q = jlog.save_image_grid(str(tmp_path / "jax.png"), maps)
    got, want = np.asarray(Image.open(p)), np.asarray(Image.open(q))
    assert got.shape == (20, 28 + 8 + 12 + 8, 3)
    np.testing.assert_array_equal(got, want)
