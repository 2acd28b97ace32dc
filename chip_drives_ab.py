#!/usr/bin/env python3
"""The MBE drives of two trees of this repository on one card, in turns.

    python3 chip_drives_ab.py OTHER_TREE [--runs parent,this,this,parent]

``OTHER_TREE`` is an unpacked copy of another commit (for example the
parent: ``git archive <commit> | tar -x -C build/parent``).  Each run is a
fresh process that imports that tree's ``chip_smoke.py`` and calls its
``main_path``: every MBE drive of phase 4 through the tree's own kernels,
each result held against the oracle, the launch counters read per drive.
The runs go in the order given (default: the other tree, this one, this
one, the other), so both trees meet the same card and host in turns.

Printed: for every drive that launches a ``fused_check`` or
``fused_select`` kind, each run's wall time and the tree's K1 / K4 launch
counts, and per tree the spread (largest - smallest wall) of its runs.
The last line is one JSON object of it all.  Needs one CUDA card; exits
non-zero when a run fails or a tree's K1 / K4 launch counts differ from
the other's.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as c
sys.path.insert(0, c.SRC)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
by_path = c.main_path(torch.device("cuda", 0))
print("AB_LAUNCHES " + json.dumps(by_path), flush=True)
"""

# a whole drive's log line (``chip_smoke.main_path``'s ``drive``)
DRIVE = re.compile(r"^  (.+?): (\d+) graphs, all n_max/cs = oracle, "
                   r"([\d.]+) s, launches (\{.*?\}), scheduler")


def run(tree: str) -> dict:
    """One ``main_path`` of ``tree`` in its own process: {drive: wall s},
    {drive: {kernel: launches}}."""
    proc = subprocess.run([sys.executable, "-c", CHILD.format(tree=tree)],
                          capture_output=True, text=True, cwd=tree)
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"chip_drives_ab.py: the run of {tree} failed "
                         f"(rc {proc.returncode})")
    walls, launches = {}, {}
    for line in proc.stdout.splitlines():
        if line.startswith("  per-graph "):
            row = json.loads(line[len("  per-graph "):])
            walls[f"{row['path']} | {row['graph']}"] = row["wall_s"]
        elif (m := DRIVE.match(line)):
            walls[f"{m.group(1)} | {m.group(2)} graphs"] = float(m.group(3))
        elif line.startswith("AB_LAUNCHES "):
            launches = json.loads(line[len("AB_LAUNCHES "):])
    return {"walls": walls, "launches": launches}


def k14(counts: dict) -> dict:
    return {k: v for k, v in counts.items()
            if k.startswith("fused_") and v}


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    order = ["parent", "this", "this", "parent"]
    if len(argv) > 2 and argv[1] == "--runs":
        order = argv[2].split(",")
    trees = {"parent": other, "this": HERE}
    import torch
    if not torch.cuda.is_available():
        print("chip_drives_ab.py: no CUDA device", file=sys.stderr)
        return 1
    runs = [(who, run(trees[who])) for who in order]
    # drives that launch a K1 / K4 kind, by the path label of the wall
    k_paths = {p for _, r in runs for p, c in r["launches"].items()
               if k14(c)}
    table = {}
    for who, r in runs:
        for drive, wall in r["walls"].items():
            if drive.split(" | ")[0] in k_paths:
                table.setdefault(drive, {}).setdefault(who, []).append(wall)
    out = {"card": torch.cuda.get_device_name(0), "order": order,
           "drives": {}, "launches": {}}
    for drive, by in table.items():
        out["drives"][drive] = {
            who: {"walls_s": ws, "spread_s": max(ws) - min(ws),
                  "mean_s": sum(ws) / len(ws)} for who, ws in by.items()}
        print(f"{drive}: " + "; ".join(
            f"{who} {', '.join(f'{w:.3f}' for w in ws)} s" for who, ws
            in by.items()))
    ok = True
    for path in sorted(k_paths):
        per = {who: k14(r["launches"].get(path, {})) for who, r in runs}
        out["launches"][path] = per
        if len({json.dumps(v, sort_keys=True) for v in per.values()}) > 1:
            ok = False
            print(f"K1/K4 launches differ on {path}: {per}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["nvidia_smi"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
