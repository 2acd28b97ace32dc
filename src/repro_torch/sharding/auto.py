"""Per-architecture sharding adaptation.

Twin of ``src/repro/sharding/auto.py``.  The rule tables in ``axes.py``
describe the *intent* (TP over heads / ff / experts, FSDP over data,
flash-decode over sequence).  Whether an axis can shard a given
architecture is a divisibility question: ``make_rules`` starts from the
mode's base table and nulls every activation axis whose dimension the
mesh does not divide; parameters shard on flattened projection dims
(H*hd, KV*hd, ...).  It reads nothing of the mesh but ``mesh.shape``.
``rules_report`` records what was dropped.
"""
from __future__ import annotations

import math

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.sharding import axes as A


def _axsize(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    return int(math.prod(mesh.shape[a] for a in names))


def make_rules(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
               multi_pod: bool = False) -> A.Rules:
    mode = "train" if shape.kind == "train" else "serve"
    if mode == "train":
        base = A.train_rules(mesh, multi_pod=multi_pod)
    else:
        batch_ok = shape.global_batch % _axsize(
            mesh, ("pod", "data") if multi_pod else ("data",)) == 0
        base = A.serve_rules(mesh, multi_pod=multi_pod,
                             batch_shardable=batch_ok)
    table = dict(base.table)
    msz = mesh.shape["model"]

    def drop_if(axis: str, dim: int):
        if table.get(axis) is not None and dim % msz != 0:
            table[axis] = None

    drop_if("act_heads", cfg.n_heads)
    drop_if("act_kv", cfg.n_kv)
    # the residual stream's positions: the vlm family's patch rows come
    # first (the reference reads the text's alone; GSPMD pads an uneven
    # split, the port keeps the sequence whole)
    seq = shape.seq_len + (cfg.patch_tokens if cfg.family == "vlm" else 0)
    if table.get("act_seq") is not None and seq % msz != 0:
        table["act_seq"] = None
    if cfg.is_moe:
        drop_if("act_expert", cfg.n_experts)
        drop_if("p_expert", cfg.n_experts)
        # experts own the model axis: the per-expert ff dim cannot also
        # shard over it
        if table.get("act_expert") is not None:
            table["act_ff"] = None
        else:
            drop_if("act_ff", cfg.d_ff)
    else:
        drop_if("act_ff", max(cfg.d_ff, 1))
    drop_if("act_vocab", cfg.padded_vocab)
    if cfg.family == "hybrid":
        # every dim that carries act_inner/p_inner must divide
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        g = math.gcd(2 * di + 2 * N + H, di + 2 * N, di, H)
        drop_if("act_inner", g)
        drop_if("p_inner", g)
    if cfg.family == "ssm":
        di = cfg.mlstm_proj * cfg.d_model
        g = math.gcd(2 * di, di, di // cfg.n_heads,
                     cfg.d_model // cfg.n_heads * cfg.n_heads * 4)
        drop_if("act_inner", g)
        drop_if("p_inner", g)

    # decode KV cache: head-TP when kv divides, else flash-decode over seq;
    # never both on one tensor.
    if mode == "serve" and table.get("cache_seq") is not None:
        if table.get("act_kv") is not None:
            # kv heads shard cleanly -> prefer zero-collective head TP
            # unless the cache seq needs every axis (unshardable batch).
            if table.get("cache_batch") is not None:
                table["cache_seq"] = None
            else:
                table["act_kv"] = None
    return A.Rules(mesh=mesh, table=table)


def rules_report(cfg: ModelConfig, rules: A.Rules) -> dict:
    """Which logical axes ended up unsharded."""
    return {k: v for k, v in rules.table.items() if v is None}
