"""int8 error-feedback gradient compression.

Twin of ``src/repro/training/compress.py``: each gradient leaf is
quantized to int8 with a per-leaf fp32 scale before it crosses the
collective axis, and the quantization error is carried into the next
step's gradient (error feedback).

The reference runs ``quantized_psum`` inside ``shard_map``, each
participant of the axis holding its own grads.  The port drives every
participant from one process, so ``grads`` and ``err`` are lists, one
dict a participant (index = its place along the axis), each on its own
device(s).  Each participant quantizes its grads (plus its residual),
its int8 codes and fp32 scale are copied to every participant (the
reference's all-gather of codes), and each participant dequantizes them
and takes the mean, in participant order, so all hold the same bits; each
keeps its own residual.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.axes import leaf_like as _same
from repro_torch.sharding.axes import leaf_parts as _parts


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 codes, fp32 scale). Symmetric per-tensor quantization."""
    x = x.float()
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def quantized_psum(grads: list, axis_name: str, err: list
                   ) -> tuple[list, list]:
    """All-reduce ``grads`` over ``axis_name`` in int8 with error feedback.

    ``grads`` and ``err`` (the residuals of the previous step, fp32, like
    the grads) hold one dict a participant of the axis.  Returns (the
    grads averaged over the participants, fp32, one dict a participant on
    its devices; the new residuals).  A leaf split over a mesh
    (``Shards``) is quantized a shard at a time, each with its own
    scale."""
    n = len(grads)
    if len(err) != n:
        raise ValueError(f"quantized_psum over {axis_name!r}: {n} grads, "
                         f"{len(err)} residuals")
    red = [{} for _ in range(n)]
    new_err = [{} for _ in range(n)]
    for k in grads[0]:
        per = []                                 # (codes, scale) per shard
        for i in range(n):
            shards, errs = [], []
            for g, e in zip(_parts(grads[i][k]), _parts(err[i][k])):
                g = g.float() + e
                codes, scale = _quantize(g)
                shards.append((codes, scale))
                errs.append(g - _dequantize(codes, scale))
            per.append(shards)
            new_err[i][k] = _same(err[i][k], errs)
        for i in range(n):
            out = []
            for s, g in enumerate(_parts(grads[i][k])):
                acc = None
                for j in range(n):               # the int8 all-gather
                    codes, scale = (t.to(g.device) for t in per[j][s])
                    x = codes.float() * scale
                    acc = x if acc is None else acc + x
                out.append(acc / n)
            red[i][k] = _same(grads[i][k], out)
    return red, new_err


def init_error_state(params: dict) -> dict:
    return {k: _same(p, [torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in _parts(p)])
            for k, p in params.items()}
