#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3,...

For each seed, in one process: the cell's timed path on inputs made from
the seed, its numbers against the reference (the program's readings),
the control's (the reference one precision down) and the planted faults'
(the traffic kind's ``calibrate`` names them).  Prints a JSON line a seed
and a summary: the largest program reading and the smallest control and
fault reading of each number, beside the cell's limits.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import Context  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench.lib import registry
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    kind = registry.traffic(wl["kind"])
    shared, rows = {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = kind.calibrate(Context(wl, cfg, seed, device), shared)
        rows.append(r)
        print(json.dumps({"seed": seed, **r}), flush=True)
    summary = {}
    for k in rows[0]["program"]:
        summary[k] = {"program_max": max(r["program"][k] for r in rows),
                      "control_min": min(r["control"][k] for r in rows),
                      "limit": wl["limits"].get(k)}
        for fault in rows[0].get("faults", {}):
            summary[k][fault + "_min"] = min(r["faults"][fault][k]
                                             for r in rows)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
