"""The port stands alone: no module of effi_mvs_plus_tpu_torch/ and no line
of chip_smoke.py, of the port's scripts or of ``tests/jax_pickle.py``
(which chip_smoke.py imports) imports jax, optax, orbax, flax or the JAX
package (an AST scan); and the train CLI refuses an unknown layout with
its reason and takes the rest."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "effi_mvs_plus_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "effi_mvs_plus_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    scripts = os.path.join(ROOT, "scripts")
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py"),
                            os.path.join(ROOT, "tests", "jax_pickle.py")] \
        + sorted(os.path.join(scripts, f) for f in os.listdir(scripts)
                 if f.startswith("torch_") and f.endswith(".py"))


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name in _imported_roots(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"


def test_scan_sees_the_package():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in rel
    assert "tests/jax_pickle.py" in rel
    assert "effi_mvs_plus_tpu_torch/models/effi_mvs.py" in rel
    assert "effi_mvs_plus_tpu_torch/ops/cuda_warp.py" in rel
    assert "scripts/torch_probe_k2k4.py" in rel
    for new in ("train/trainer.py", "cli/train.py", "utils/logging.py",
                "config.py", "data/datasets.py", "ops/cuda_conv.py",
                "fuse/dypcd.py", "fuse/ply.py", "eval/dtu.py",
                "cli/test_tank.py", "cli/test_dtu.py", "cli/eval_dtu.py",
                "ops/conv_pack.py", "ops/rounding_bounds.py",
                "utils/profiling.py", "parallel/__init__.py",
                "parallel/distributed.py", "parallel/mesh.py",
                "parallel/equivalence.py", "data/registry.py",
                "data/loader.py", "infer/engine.py", "fuse/static.py",
                "fuse/legacy.py", "fuse/gipuma.py", "train/metrics.py",
                "native/__init__.py", "entry.py", "data/device_cache.py",
                "io/jax_checkpoint.py", "io/torch_import.py"):
        assert f"effi_mvs_plus_tpu_torch/{new}" in rel


# the case ids keep the reasons the first two flags were once refused with
@pytest.mark.parametrize("flag,why", [
    (["--device_cache"], None),
    (["--shard_policy", "depth,spatial"], None),
    (["--shard_policy", "spatial"], None),
    (["--shard_policy", "views,spatial"], None),
    (["--shard_policy", "rows"], "unknown layout"),
    (["--shard_policy", ""], "no model-axis layout")], ids=[
        "flag0-a GPU host has no such link", "flag1-ROADMAP A11d",
        "flag2-None", "flag3-None", "flag4-unknown layout",
        "flag5-no model-axis layout"])
def test_train_cli_refusals_give_their_reason(flag, why):
    """A layout the port does not know refuses before any work, naming
    why; the device cache and every combination of views, depth and
    spatial (``why`` None) are taken, and one process with two model
    ranks is then refused by the grid's check."""
    from effi_mvs_plus_tpu_torch.cli import train
    if why is None:
        flag, why = flag + ["--model_parallel", "2"], "needs 2 processes"
    with pytest.raises(SystemExit, match=why):
        train.main(flag + ["--device", "cpu"])
