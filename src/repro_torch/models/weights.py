"""Carry weights from the reference package into the port.

The port draws its random weights from a ``torch.Generator`` and the
reference from ``jax.random``, so the same seed gives different numbers.
To run both packages on the same model, take the reference's parameters
as numpy arrays (``{k: np.asarray(v) for k, v in params.items()}``) and
convert them here; names, shapes and dtypes are kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import check_device


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable: torch keeps it
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 (JAX's)
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: dict[str, np.ndarray], device="cuda"
                    ) -> dict[str, torch.Tensor]:
    """The reference's flat parameter dict (numpy arrays) as the port's
    (tensors on ``device``, same names, shapes and dtypes)."""
    dev = check_device(device)
    return {name: _tensor(np.asarray(a)).to(dev)
            for name, a in np_params.items()}
