#!/usr/bin/env python3
"""The MBE drives and two kernels of two trees of this repository on one
card, in turns.

    python3 chip_drives_ab.py OTHER_TREE [--runs parent,this,this,parent]
                              [--kernels-only]

``OTHER_TREE`` is an unpacked copy of another commit (for example the
parent: ``git archive <commit> | tar -x -C build/parent``).  Each run is a
fresh process that imports that tree's ``chip_smoke.py`` and calls its
``main_path``: every MBE drive of phase 4 through the tree's own kernels,
each result held against the oracle, the launch counters read per drive
(skipped with ``--kernels-only``).  Then, in the same process, the tree's
own K5 (``intersect_count``) and fp32 K7 forward on operands made from the
same seeds: K5's call time (CUDA events), queued device time and profiler
time at its path's shape (1 lane, 512 x 64 words through ``idx``), and
the fp32 forward's call time at each of ``FWD_CASES`` (and its profiler
time at the fp32 grad path's (2, 4096)); their outputs are saved and
compared across runs.  The runs go in the order given (default: the
other tree, this one, this one, the other), so both trees meet the same
card and host in turns.

Printed: for every drive that launches a ``fused_check``,
``fused_select`` or ``intersect_count`` kind, each run's wall time and the
tree's K1 / K4 / K5 launch counts, and per tree the spread (largest -
smallest wall) of its runs; each run's kernel times; for each fp32
forward case the largest |difference| of o and lse between the trees and
between two runs of one tree, and whether they are bit-identical.  The
last line is one JSON object of it all.  Needs one CUDA card; exits
non-zero when a run fails, when a tree's K1 / K4 / K5 launch counts
differ from the other's, or when K5's counts differ between the trees.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "ab_kernels")

# the fp32 K7 forward cases: (B, S, H, KV, hd, causal); the first is the
# fp32 grad path's layer
FWD_CASES = ((2, 4096, 16, 8, 128, True), (2, 1000, 16, 8, 128, True),
             (1, 4097, 16, 8, 128, True), (2, 1000, 12, 4, 64, True),
             (2, 256, 8, 2, 128, False), (2, 1000, 8, 4, 32, True),
             (2, 333, 8, 2, 16, False))

CHILD = r"""
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as c
sys.path.insert(0, c.SRC)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
if {drives!r}:
    by_path = c.main_path(dev)
    print("AB_LAUNCHES " + json.dumps(by_path), flush=True)
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.intersect_count.ops import intersect_count
out, saved = {{}}, {{}}
g = torch.Generator(device=dev).manual_seed(5)
def words(*shape):
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=g, device=dev,
                         dtype=torch.int32)
adj, mask = words(1, 512, 64) & words(1, 512, 64), words(1, 64)
idx = torch.argsort(torch.rand(1, 512, generator=g, device=dev),
                    dim=-1).to(torch.int32).contiguous()
k5 = lambda: intersect_count(adj, mask, idx=idx, impl="pallas")
saved["k5"] = k5().cpu()
out["k5"] = dict(ms=c.cuda_ms(k5), queued_ms=c.queued_ms(k5),
                 device_ms=c.device_ms(k5, "intersect_count_kernel"))
for case in {cases!r}:
    B, S, H, KV, hd, causal = case
    qp, kp, vp = c.k7_operands(B, S, H, KV, hd, "float32", dev, seed=S + hd)
    kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
    f = lambda: flash_fwd(qp, kp, vp, **kw)
    o, lse = f()
    saved[str(case)] = (o[..., :S, :].cpu(), lse[..., :S].cpu())
    t = dict(ms=c.cuda_ms(f, reps=5))
    if case == {cases!r}[0]:
        t["device_ms"] = c.device_ms(f, "flash_fwd_f32", reps=5)
    out[str(case)] = t
    del qp, kp, vp, o, lse
torch.save(saved, {path!r})
print("AB_KERNELS " + json.dumps(out), flush=True)
"""

# a whole drive's log line (``chip_smoke.main_path``'s ``drive``)
DRIVE = re.compile(r"^  (.+?): (\d+) graphs, all n_max/cs = oracle, "
                   r"([\d.]+) s, launches (\{.*?\}), scheduler")


def run(tree: str, drives: bool, path: str) -> dict:
    """One run of ``tree`` in its own process: {drive: wall s}, {drive:
    {kernel: launches}}, {kernel: times}; its kernels' outputs in
    ``path``."""
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(tree=tree, drives=drives,
                                            cases=FWD_CASES, path=path)],
        capture_output=True, text=True, cwd=tree)
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"chip_drives_ab.py: the run of {tree} failed "
                         f"(rc {proc.returncode})")
    walls, launches, kernels = {}, {}, {}
    for line in proc.stdout.splitlines():
        if line.startswith("  per-graph "):
            row = json.loads(line[len("  per-graph "):])
            walls[f"{row['path']} | {row['graph']}"] = row["wall_s"]
        elif (m := DRIVE.match(line)):
            walls[f"{m.group(1)} | {m.group(2)} graphs"] = float(m.group(3))
        elif line.startswith("AB_LAUNCHES "):
            launches = json.loads(line[len("AB_LAUNCHES "):])
        elif line.startswith("AB_KERNELS "):
            kernels = json.loads(line[len("AB_KERNELS "):])
    return {"walls": walls, "launches": launches, "kernels": kernels}


def row_kernels(counts: dict) -> dict:
    """The K1 / K4 / K5 launch counts of a drive."""
    return {k: v for k, v in counts.items()
            if (k.startswith("fused_") or k == "intersect_count") and v}


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def compare_outputs(order: list[str], paths: list[str]) -> dict:
    """Each fp32 forward case and K5's counts: the largest |difference|
    between the trees' first runs, and between the two runs of each tree."""
    import torch
    saved = [torch.load(p) for p in paths]
    first = {who: order.index(who) for who in set(order)}
    out = {}
    for key in saved[0]:
        row = {}
        pairs = [("trees", first["parent"], first["this"])] if len(
            first) == 2 else []
        for who, i in first.items():
            j = [n for n, w in enumerate(order) if w == who]
            if len(j) > 1:
                pairs.append((f"{who} rerun", j[0], j[1]))
        for tag, i, j in pairs:
            a, b = saved[i][key], saved[j][key]
            if isinstance(a, tuple):
                row[tag] = dict(o=max_diff(a[0], b[0]),
                                lse=max_diff(a[1], b[1]),
                                identical=bool(torch.equal(a[0], b[0])
                                               and torch.equal(a[1], b[1])))
            else:
                row[tag] = dict(counts=max_diff(a, b),
                                identical=bool(torch.equal(a, b)))
        out[key] = row
        print(f"{key}: " + json.dumps(row))
    return out


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    order = ["parent", "this", "this", "parent"]
    if "--runs" in argv:
        order = argv[argv.index("--runs") + 1].split(",")
    drives = "--kernels-only" not in argv
    trees = {"parent": other, "this": HERE}
    import torch
    if not torch.cuda.is_available():
        print("chip_drives_ab.py: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    paths = [os.path.join(OUT, f"run{i}_{who}.pt")
             for i, who in enumerate(order)]
    runs = [(who, run(trees[who], drives, p))
            for (who, p) in zip(order, paths)]
    # drives that launch a K1 / K4 / K5 kind, by the path label of the wall
    k_paths = {p for _, r in runs for p, c in r["launches"].items()
               if row_kernels(c)}
    table = {}
    for who, r in runs:
        for drive, wall in r["walls"].items():
            if drive.split(" | ")[0] in k_paths:
                table.setdefault(drive, {}).setdefault(who, []).append(wall)
    out = {"card": torch.cuda.get_device_name(0), "order": order,
           "drives": {}, "launches": {},
           "kernels": [{"tree": who, **r["kernels"]} for who, r in runs]}
    for drive, by in table.items():
        out["drives"][drive] = {
            who: {"walls_s": ws, "spread_s": max(ws) - min(ws),
                  "mean_s": sum(ws) / len(ws)} for who, ws in by.items()}
        print(f"{drive}: " + "; ".join(
            f"{who} {', '.join(f'{w:.3f}' for w in ws)} s" for who, ws
            in by.items()))
    ok = True
    for path in sorted(k_paths):
        per = {who: row_kernels(r["launches"].get(path, {}))
               for who, r in runs}
        out["launches"][path] = per
        if len({json.dumps(v, sort_keys=True) for v in per.values()}) > 1:
            ok = False
            print(f"K1/K4/K5 launches differ on {path}: {per}")
    for who, r in runs:
        print(f"kernels {who}: " + json.dumps(r["kernels"]))
    out["outputs"] = compare_outputs(order, paths)
    k5 = out["outputs"]["k5"]
    if not all(v["identical"] for v in k5.values()):
        ok = False
        print(f"K5's counts differ: {k5}")
    shutil.rmtree(OUT, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["nvidia_smi"] = smi.stdout.strip()
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
