"""Architecture registry: ``--arch <id>`` resolves here.

Twin of ``src/repro/configs/__init__.py``.  Each module defines CONFIG
(the exact published config) and SMOKE (a reduced same-family config for
CPU tests); the modules are copies of the reference's, pure data.
``cumbe`` is the paper's own workload (an ``MBEWorkload``, not a
``ModelConfig``).  ``input_specs`` (the dry-run's abstract inputs) and
the cache sizing ``round_up`` / ``cache_len`` wait for the dry run
(ROADMAP Queue 1 item 12d).
"""
from __future__ import annotations

import importlib

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

