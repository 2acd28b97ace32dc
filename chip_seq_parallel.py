#!/usr/bin/env python3
"""The residual stream's sequence split over ``model`` (Megatron sequence
parallelism) against the table with ``act_seq=None``, on every visible
card (or ``chip_smoke.REHEARSAL_SHARDS`` shards of one).

    python3 chip_seq_parallel.py              # walls, split vs whole
    python3 chip_seq_parallel.py --phases     # chip_smoke's mesh phases

The default runs, in one process at full width (random weights, seed 0)
on ``chip_smoke.lm_mesh``'s model=4 mesh, each drive three times: under
``make_rules``' table (the split), under the same table with
``act_seq=None`` (the sequence whole on every model shard) and split
again, each held against one device by ``chip_smoke.mesh_prefill``:
qwen3-1.7b's prefill at ``chip_smoke.LM_PREFILL``, zamba2-7b's (12
layers, (1, 4096)) and xlstm-1.3b's (8 layers, (1, 1024)); then
qwen3-1.7b's bf16 grads (``chip_smoke.mesh_grads`` with ``whole_too``:
split against whole, peak memory by card of each).  ``--phases`` runs
``chip_smoke.py``'s ``train_path`` (the one-device AdamW history),
``lm_mesh_path`` and ``hybrid_ssm_mesh_path`` instead: the mesh phases
alone, for a machine with several cards.  Prints the card's name and
power limit, then one JSON object (the walls) as the last line; exits
non-zero where a check of ``chip_smoke.py`` fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

SPLITS = (("split", False), ("whole", True), ("split again", False))


@contextlib.contextmanager
def whole_sequence():
    """``make_rules`` giving its table with ``act_seq=None``."""
    from repro_torch.sharding import auto, axes
    real = auto.make_rules

    def rules(*a, **kw):
        r = real(*a, **kw)
        return axes.Rules(mesh=r.mesh, table=dict(r.table, act_seq=None))
    auto.make_rules = rules
    try:
        yield
    finally:
        auto.make_rules = real


def walls(dev) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    by, out = {}, {}
    mesh, _ = cs.lm_mesh(dev, cs.LM_MESH_MODEL)
    cs.log(f"  mesh {mesh}")
    drives = [(cs.LM_ARCH, None, cs.LM_PREFILL, False),
              ("zamba2-7b", cs.ZAMBA_MESH_LAYERS, [(1, 4096)], True),
              ("xlstm-1.3b", cs.XLSTM_MESH_LAYERS, [(1, 1024)], True)]
    for arch, layers, shapes, floor in drives:
        cfg = dataclasses.replace(configs.get_config(arch), remat=True,
                                  attn_impl="pallas")
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = M.cast_params(cfg, init_params(M.param_specs(cfg), 0,
                                                device=dev))
        for tag, whole in SPLITS:
            for B, S in shapes:
                with whole_sequence() if whole else contextlib.nullcontext():
                    r = cs.mesh_prefill(cfg, params, mesh, B, S,
                                        f"{tag} {arch} prefill ({B}, {S})",
                                        by, seed=S + B, floor=floor)
                out[f"{tag} {arch} prefill {B}x{S}"] = r["wall_s"]
        del params
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get_config(cs.LM_ARCH), remat=True,
                              attn_impl="pallas")
    master = init_params(M.param_specs(cfg), 0, device=dev)
    g = cs.mesh_grads(cfg, master, mesh, by, whole_too=True)
    out["grads split"] = g["wall_s"]
    out["grads whole"] = g["act_seq_none"]["wall_s"]
    out["grads peak_gb split"] = g["peak_gb"]
    out["grads peak_gb whole"] = g["act_seq_none"]["peak_gb"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_seq_parallel.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cs.log(f"[device] {torch.cuda.get_device_name(0)} x "
           f"{torch.cuda.device_count()}, torch {torch.__version__}")
    _build.library()
    try:
        if "--phases" in sys.argv[1:]:
            by = {}
            train = cs.train_path(dev, by)
            cs.lm_mesh_path(dev, by, train)
            cs.hybrid_ssm_mesh_path(dev, by)
            out = {"phases_s": time.perf_counter() - t0}
        else:
            out = walls(dev)
    except cs.PhaseError as e:
        print(f"chip_seq_parallel.py: FAILED: {e}", file=sys.stderr,
              flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(smi.stdout.strip().splitlines()[0] if smi.stdout else "")
    cs.log(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, cs.SRC)
    sys.exit(main())
