"""The benchmark's parts found by name: a cell is
``workloads/<cell>.json`` (its configuration, its traffic mix: the
generator's ``kind`` and its ``params``, its chips and limits), its
configuration ``configs/<config>.json``, the mix's generator
``traffic/<kind>.py`` and each per-layer metric ``metrics/<metric>.py``,
all under the benchmark's folder.  Which
metrics a cell reports comes from ``BENCHMARK.json`` at the root of the
checkout.  Adding a part is adding its file and its entry."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # the benchmark folder
ROOT = HERE.parent                                     # the checkout
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Unknown(LookupError):
    """A name with no file behind it."""


def _path(kind, name, suffix, root):
    if not _NAME.match(name):
        raise Unknown(f"{kind} name {name!r} is not a valid name")
    p = Path(root) / kind / f"{name}{suffix}"
    if not p.is_file():
        raise Unknown(f"no {kind[:-1] if kind.endswith('s') else kind} "
                      f"named {name!r} ({p} is missing)")
    return p


def load_json(kind, name, root=HERE):
    with open(_path(kind, name, ".json", root)) as f:
        return json.load(f)


def workload(name, root=HERE):
    return load_json("workloads", name, root)


def config(name, root=HERE):
    return load_json("configs", name, root)


def _module(kind, name, root):
    p = _path(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind, root=HERE):
    return _module("traffic", kind, root)


def metric(name, root=HERE):
    return _module("metrics", name, root)


def benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench, cell, section):
    """The metrics of ``section`` ('end_to_end' or 'per_layer') that the
    cell reports: those that list it, and those without a list that move
    (per-layer) or are (end-to-end) a metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e
                             else [])]
