"""int8 error-feedback gradient compression.

Twin of ``src/repro/training/compress.py``: each gradient leaf is
quantized to int8 with a per-leaf fp32 scale before the cross-device
reduction, and the quantization error is carried into the next step's
gradient (error feedback).  ``_quantize``, ``_dequantize`` and
``init_error_state`` are ported; ``quantized_psum`` reduces over a
collective axis across devices, which waits for the multi-GPU item
(ROADMAP Queue 1 item 8), and raises until then.
"""
from __future__ import annotations

import torch


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 codes, fp32 scale). Symmetric per-tensor quantization."""
    x = x.float()
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def quantized_psum(grads: dict, axis_name: str, err: dict):
    """All-reduce ``grads`` over ``axis_name`` in int8 with error feedback
    (the reference's ``quantized_psum``): not ported yet."""
    raise NotImplementedError(
        f"quantized_psum over {axis_name!r}: the int8 all-gather needs a "
        f"collective axis across devices, which waits for the multi-GPU "
        f"item (ROADMAP Queue 1 item 8)")


def init_error_state(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
