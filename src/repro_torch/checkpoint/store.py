"""Commit-marked checkpoints in the reference's on-disk format.

Twin of ``src/repro/checkpoint/store.py`` for one host, over trees of
tensors: dicts (flattened in sorted key order) and ``AdamWState`` (a
NamedTuple, in field order).  The format is the reference's, so either
package restores the other's checkpoints:

* ``<dir>/step_%010d/`` holds one ``.npy`` per leaf and ``manifest.json``
  (step, extra, and per leaf its key, file, shape and dtype); a ``COMMIT``
  marker is written LAST, and readers ignore uncommitted directories.
* A leaf's key is its path as ``jax.tree_util.keystr`` spells it, e.g.
  ``['opt'].mu['embed/tok']`` or ``['params']['embed/tok']``; its file is
  the key with ``/`` replaced by ``__``, plus ``.npy``.
* bf16 leaves are written as raw 2-byte words (``np.save`` of ml_dtypes'
  bfloat16, as the reference writes them, loads back as raw ``V2``
  words) with ``"bfloat16"`` in the manifest, and read back without
  ml_dtypes.

A leaf split over a mesh (``sharding.axes.Shards``) is saved whole, its
shards gathered, so a checkpoint does not depend on the mesh it was
written from; ``restore`` with ``shardings`` (a tree like ``tree_like``
of ``NamedSharding``s, or None for a leaf placed whole) cuts each leaf
into the mesh's layout, as the reference restores with shardings.

``CheckpointManager`` adds keep-N retention and async writes: the device
-> host copy is synchronous, the files are written on a background
thread, ``wait()`` joins the writes (and is called before a restore and
before deleting old steps).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.dispatch import check_device
from repro_torch.sharding.axes import Shards

_MANIFEST = "manifest.json"
_COMMIT = "COMMIT"


def _encode_key(path: str) -> str:
    return path.replace("/", "__")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's order and spelling."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, f"{prefix}[{k!r}]")
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       f"{prefix}.{f}")
                            for f in tree._fields))
    return leaves[prefix]


def _to_host(x) -> np.ndarray:
    """A leaf copied to a numpy array (a copy even on the CPU: the
    optimizer updates its moments in place while an async write runs);
    bf16 as raw 2-byte words (dtype V2); a sharded leaf whole."""
    if isinstance(x, Shards):
        x = x.full("cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.array(x, copy=True)


def _dtype_name(x, host: np.ndarray) -> str:
    if isinstance(x, (torch.Tensor, Shards)) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def save(directory: str, step: int, tree: Any, *,
         extra: dict | None = None) -> str:
    """Synchronous commit-marked save. Returns the step directory."""
    return _write(directory, step, _snapshot(tree), extra)


def _snapshot(tree: Any) -> list[tuple[str, np.ndarray, str]]:
    out = []
    for k, x in _flatten(tree):
        host = _to_host(x)
        out.append((k, host, _dtype_name(x, host)))
    return out


def _write(directory: str, step: int,
           leaves: list[tuple[str, np.ndarray, str]],
           extra: dict | None) -> str:
    sdir = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(sdir, exist_ok=True)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": [{"key": name, "file": _encode_key(name) + ".npy",
                    "shape": list(host.shape), "dtype": dtype}
                   for name, host, dtype in leaves],
    }
    for name, host, _ in leaves:
        np.save(os.path.join(sdir, _encode_key(name) + ".npy"), host,
                allow_pickle=False)
    with open(os.path.join(sdir, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(sdir, _COMMIT), "w") as f:
        f.write("ok")
    return sdir


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, _COMMIT)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.array(arr, copy=True))


def restore(directory: str, tree_like: Any, *, step: int | None = None,
            device="cuda", shardings: Any = None) -> tuple[Any, dict]:
    """Restore a tree shaped like ``tree_like`` (its leaves are only
    placeholders: the names come from its structure, the values, shapes
    and dtypes from the files) onto ``device``, or, where ``shardings``
    names a ``NamedSharding`` for a leaf, into that split over its mesh.
    Returns (tree, extra)."""
    dev = check_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    sdir = os.path.join(directory, f"step_{step:010d}")
    if not os.path.exists(os.path.join(sdir, _COMMIT)):
        raise FileNotFoundError(f"step {step} not committed in {directory}")
    with open(os.path.join(sdir, _MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    layout = dict(_flatten(shardings)) if shardings is not None else {}
    leaves = {}
    for name, _ in _flatten(tree_like):
        entry = by_key.get(name)
        if entry is None:
            raise KeyError(f"checkpoint {sdir} missing leaf {name}")
        arr = np.load(os.path.join(sdir, entry["file"]), allow_pickle=False)
        x = _from_host(arr, entry["dtype"])
        sh = layout.get(name)
        leaves[name] = sh.shard(x) if sh is not None else x.to(dev)
    return _unflatten(tree_like, leaves), manifest.get("extra", {})


class CheckpointManager:
    """Retention + optional async writes on top of save/restore."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: list[threading.Thread] = []
        self._errors: list[Exception] = []
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        leaves = _snapshot(tree)        # synchronous device -> host copy
        if not self.async_save:
            _write(self.directory, step, leaves, extra)
            self._gc()
            return

        def work():
            try:
                _write(self.directory, step, leaves, extra)
            except Exception as e:      # re-raised by wait()
                self._errors.append(e)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._pending.append(t)

    def wait(self) -> None:
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError("checkpoint write failed") from err
        self._gc()

    def restore_latest(self, tree_like: Any, device="cuda",
                       shardings: Any = None
                       ) -> tuple[Any, dict, int] | None:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, extra = restore(self.directory, tree_like, step=step,
                              device=device, shardings=shardings)
        return tree, extra, step

    def _gc(self) -> None:
        steps = _committed_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
