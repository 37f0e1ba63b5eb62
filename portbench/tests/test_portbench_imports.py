"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port: module names compared by their
top-level part, whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "effi_mvs_plus_tpu"}
PORT = "effi_mvs_plus_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(HERE)): top_level_imports(p) & FORBIDDEN
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_port():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    for p in files:
        names = top_level_imports(p)
        assert PORT not in names, p
        assert names <= {"__future__", "math", "re", "numpy", "torch",
                         "portbench"}, (p, names)


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(f"import {PORT}.models\nfrom jax import numpy\n"
                 "import jaxtyping\n")
    names = top_level_imports(p)
    assert names & FORBIDDEN == {"jax"}
    assert PORT in names and "jaxtyping" in names
