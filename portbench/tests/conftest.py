"""A tiny copy of the benchmark's cells for the CPU: the same traffic
kinds, metrics, configurations and limits, at 64x96 with 3 views, B=2
and fp32 compute, so the port's plain CPU path can stand in for the
card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(height=64, width=96, views=3)


def make_tiny(dest):
    for d in ("traffic", "metrics"):
        shutil.copytree(HERE / d, dest / d)
    (dest / "configs").mkdir()
    (dest / "workloads").mkdir()
    for p in (HERE / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        s = TINY["width"] / c["input"]["width"]
        c["input"] = dict(TINY)
        c["scene"]["intrinsics"] = [v * s for v in c["scene"]["intrinsics"]]
        c["scene"]["texture_size"] = 64
        c["model"]["compute_dtype"] = "float32"
        if "train" in c:
            c["train"]["batch_size"] = 2
        (dest / "configs" / p.name).write_text(json.dumps(c))
    for p in (HERE / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        if "batch" in w["params"]:
            w["params"]["batch"] = min(w["params"]["batch"], 2)
        w["params"]["trace_units"] = 2
        (dest / "workloads" / p.name).write_text(json.dumps(w))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
