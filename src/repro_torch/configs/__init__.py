"""Architecture registry: ``--arch <id>`` resolves here.

Twin of ``src/repro/configs/__init__.py``.  Each module defines CONFIG
(the exact published config) and SMOKE (a reduced same-family config for
CPU tests); the modules are copies of the reference's, pure data.
``cumbe`` is the paper's own workload (an ``MBEWorkload``, not a
``ModelConfig``).  ``input_specs`` builds the stand-ins for every model
input of an (arch x shape) cell: tensors on the ``meta`` device (the
reference's ``ShapeDtypeStruct``: a shape and a dtype, no storage), which
the dry run (``launch/dryrun.py``) traces against.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import ModelConfig, ShapeSpec, SHAPES  # noqa: F401

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-3-8b": "granite_3_8b",
    "llama3.2-3b": "llama3_2_3b",
    "llama3-8b": "llama3_8b",
    "dbrx-132b": "dbrx_132b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "internvl2-2b": "internvl2_2b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "cumbe": "cumbe",            # the paper's own workload
}

ARCH_IDS = [k for k in _MODULES if k != "cumbe"]


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE



def round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Decode KV-cache capacity: seq (+ vlm patch prefix), padded so any
    sequence sharding in the production meshes divides."""
    return round_up(shape.seq_len + cfg.patch_tokens, 1024)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors of the reference's shapes and dtypes for every
    input of (arch x shape): tokens (and labels, patch embeddings) for
    train / prefill; the cache, tokens and position for decode.  Nothing
    is allocated."""
    from repro_torch.models import model as M

    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta(tok_shape, i32)}
        if shape.kind == "train":
            specs["labels"] = _meta(tok_shape, i32)
        if cfg.family == "vlm":
            specs["patch_emb"] = _meta((B, cfg.patch_tokens, cfg.d_model),
                                       _DTYPES[cfg.dtype])
        return specs

    assert shape.kind == "decode"
    tok = (B, cfg.n_codebooks) if cfg.n_codebooks else (B,)
    return {
        "cache": {k: _meta(shp, dt) for k, (shp, dt) in
                  M.cache_specs(cfg, B, cache_len(cfg, shape)).items()},
        "tokens": _meta(tok, i32),
        "pos": _meta((), i32),
    }
