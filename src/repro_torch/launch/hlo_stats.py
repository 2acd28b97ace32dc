"""Dry-run profiler: FLOPs, HBM bytes and collective bytes of a traced
call, counted from the aten operators the port dispatches.

Twin by path of ``src/repro/launch/hlo_stats.py``, which re-derives
these figures from XLA's compiled HLO text.  The port makes no HLO: this
module counts the aten operators a call dispatches while it runs, as a
``TorchDispatchMode`` (on ``meta`` tensors the call computes nothing but
shapes).  The figures keep the reference record's keys and cost model:

* ``flops``: 2 * M * N * K a product, by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, attention; an
  ``einsum`` or ``matmul`` reaches them); ``conv_flops``: those of
  ``aten.convolution`` (the port's causal conv is elementwise
  multiply-adds, so it counts none; the reference counts its
  depthwise convolution there).
* ``hbm_bytes``: the reference's anchor-op model.  Products, reductions,
  copies, concatenations and collectives read their operands and write
  their outputs; a gather costs twice its output, a scatter or in-place
  copy twice its update; elementwise operators, casts and views count as
  fused (no bytes).  Widths are the tensors' own dtypes: the port's
  tensors already have the width the card moves, where the reference
  narrows the CPU compiler's widened HLO.
* ``collectives``: operand bytes by type (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), their
  ``total`` and ``counts``, as the port's collectives report them
  (``sharding.axes.report``: ``sharding/collectives.py`` and the gathers
  and takes of ``sharding.axes.Shards``), forward and backward: the
  counter installs itself as their recorder (``axes.recording``).

**Per device.**  The reference's figures are one device's SPMD program.
On a mesh the dry run traces under ``sharding.axes.lead()``: the single
controller runs device 0's share only, so every operator counted is
device 0's.  The figures are device 0's program; devices differ only in
what the mesh's first device does more (the logits brought whole, the
loss's sums), so device 0's is also the largest.  No scaling is applied
(no loop or layer is counted once and multiplied): every operator of
device 0's program is dispatched and counted.

**Memory.**  ``peak_bytes`` is the peak of the bytes of live storages
that operators made during the trace (each storage once, however many
views share it; freed when its last tensor is), the dry run's
``temp_size_in_bytes``: storages that existed before the trace (the
arguments, given as ``existing``), and views of them, are not counted.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding import axes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten

_CONV = {aten.convolution, aten._convolution, aten.convolution_backward,
         aten.cudnn_convolution, aten.convolution_overrideable,
         aten._slow_conv2d_forward}
_PRODUCTS = set(flop_registry) - _CONV


def _packets(*names) -> set:
    return {getattr(aten, n) for n in names if hasattr(aten, n)}


# reductions, sorts and the softmax family: read the operands, write the
# output
_REDUCTIONS = _packets(
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "logsumexp", "cumsum", "cumprod", "prod", "var", "var_mean", "std",
    "std_mean", "norm", "linalg_vector_norm", "any", "all", "aminmax",
    "count_nonzero", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "sort", "topk", "nll_loss_forward",
    "nll_loss_backward", "cummax", "cummin")
# copies and layout changes that write a new buffer
_COPIES = _packets("clone", "_copy_from", "cat", "stack", "constant_pad_nd",
                   "flip", "roll", "repeat", "_unsafe_view_copy")
# gathers: twice the output (the rows read and written)
_GATHERS = _packets("index", "index_select", "gather", "embedding", "take",
                    "masked_select", "narrow_copy")
# scatters and in-place updates: twice the update; the argument that holds
# the update
_SCATTERS = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
             aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
             aten.scatter_add_: 3, aten.scatter_reduce: 3,
             aten.scatter_reduce_: 3, aten.index_add: 3, aten.index_add_: 3,
             aten.index_copy: 3, aten.index_copy_: 3, aten.slice_scatter: 1,
             aten.select_scatter: 1, aten.diagonal_scatter: 1,
             aten.masked_scatter: 2, aten.masked_scatter_: 2, aten.copy_: 1,
             aten.copy: 1, aten.embedding_dense_backward: 0}

def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts the dispatched aten operators (see the module docstring);
    ``stats()`` gives the reference record's figures."""

    def __init__(self, existing=()):
        super().__init__()
        # storages that exist before the trace (the arguments): views of
        # them made during the trace are not new memory
        self._skip = {t.untyped_storage()._cdata for t in existing}
        self.flops = 0
        self.conv_flops = 0
        self.hbm_bytes = 0
        self.by_coll: dict[str, int] = defaultdict(int)
        self.coll_counts: dict[str, int] = defaultdict(int)
        self.n_ops = 0
        self._paused = 0
        self._recording = None
        self.live = 0
        self.peak = 0
        self._live: dict[int, list[int]] = {}

    def __enter__(self):
        self._recording = axes.recording(self)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *a):
        self._recording.__exit__(None, None, None)
        return super().__exit__(*a)

    @contextlib.contextmanager
    def paused(self):
        """Operators run here are not counted (a collective's stand-in);
        the storages they make are still tracked."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ---- operators -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            self._track(out)
            return out
        self.n_ops += 1
        pk = func.overloadpacket
        if pk in _PRODUCTS or pk in _CONV:
            f = flop_registry[pk](*args, **kwargs, out_val=out)
            if pk in _CONV:
                self.conv_flops += f
            else:
                self.flops += f
            self.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.hbm_bytes += sum(map(_nbytes, _tensors(out)))
        elif pk in _REDUCTIONS or pk in _COPIES:
            self.hbm_bytes += sum(map(_nbytes, _tensors((args, kwargs))))
            self.hbm_bytes += sum(map(_nbytes, _tensors(out)))
        elif pk in _GATHERS:
            self.hbm_bytes += 2 * sum(map(_nbytes, _tensors(out)))
        elif pk in _SCATTERS:
            i = _SCATTERS[pk]
            upd = args[i] if i < len(args) else kwargs.get("src")
            if isinstance(upd, (list, tuple)):
                upd = None
            self.hbm_bytes += 2 * _nbytes(upd)
        self._track(out)
        return out

    def collective(self, kind: str, nb: int, out_b: int) -> None:
        if self._paused:
            return
        self.by_coll[kind] += nb
        self.coll_counts[kind] += 1
        self.hbm_bytes += nb + out_b

    # ---- live storages ---------------------------------------------------
    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._skip:
                continue
            ent = self._live.get(key)
            if ent is None:
                ent = self._live[key] = [st.nbytes(), 0]
                self.live += ent[0]
                self.peak = max(self.peak, self.live)
            ent[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._live[key]

    def stats(self) -> dict:
        coll = {k: int(self.by_coll.get(k, 0)) for k in COLLECTIVES}
        coll["total"] = sum(coll.values())
        coll["counts"] = {k: int(v) for k, v in self.coll_counts.items()}
        return dict(flops=float(self.flops),
                    conv_flops=float(self.conv_flops),
                    hbm_bytes=float(self.hbm_bytes), collectives=coll,
                    n_ops=self.n_ops, peak_bytes=int(self.peak))


def module_stats(fn, *args, **kwargs) -> dict:
    """The reference's ``module_stats`` for a call: ``fn(*args,
    **kwargs)`` run under an ``OpCounter``; its figures (``stats``) and
    the call's result under ``"result"``."""
    with OpCounter(_tensors((args, kwargs))) as c:
        res = fn(*args, **kwargs)
    return dict(c.stats(), result=res)
