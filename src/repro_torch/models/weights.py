"""Carry weights from the reference package into the port.

The port draws its random weights from a ``torch.Generator`` and the
reference from ``jax.random``, so the same seed gives different numbers.
To run both packages on the same model, take the reference's parameters
as numpy arrays (``{k: np.asarray(v) for k, v in params.items()}``) and
convert them here; names, shapes and dtypes are kept.  With ``specs``
and mesh ``rules`` the converted leaves are then split over the mesh
(``layers.shard_params``), so both packages compute from the same
weights on a mesh too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import check_device
from repro_torch.models.layers import shard_params


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable: torch keeps it
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 (JAX's)
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: dict[str, np.ndarray], device="cuda", *,
                    specs=None, rules=None) -> dict:
    """The reference's flat parameter dict (numpy arrays) as the port's
    (tensors on ``device``, same names, shapes and dtypes); split over
    ``rules.mesh`` by ``specs``' logical axes when both are given."""
    dev = check_device(device)
    out = {name: _tensor(np.asarray(a)).to(dev)
           for name, a in np_params.items()}
    if rules is not None:
        out = shard_params(out, specs, rules)
    return out
