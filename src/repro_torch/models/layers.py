"""Shared neural layers (functional, params as flat dicts of tensors).

Twin of ``src/repro/models/layers.py``.  Parameters live in a flat
``dict[str, torch.Tensor]`` keyed by '/'-joined paths; each model family
declares its parameters as a table of ``ParamSpec(shape, logical_axes,
init)``, the single source from which initialization, the parameter
count and the sharding derive (see ``model.py``).

``shard_params(params, specs, rules)`` is the port's counterpart of the
reference launchers' ``device_put(v, NamedSharding(mesh, spec_for(...)))``:
each leaf becomes a ``sharding.axes.Shards`` split by its logical axes
under ``rules``; ``gather_params`` is its inverse (whole leaves on one
device).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import check_device
from repro_torch.sharding.axes import Shards, constrain, named_sharding


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]   # logical axis per dim
    init: str = "normal"              # normal | zeros | ones
    scale: float = 1.0                # stddev multiplier for 'normal'

    def materialize(self, gen: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=torch.float32, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=torch.float32, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std)


def init_params(specs: dict[str, ParamSpec], seed: int = 0, *,
                device="cuda") -> dict[str, torch.Tensor]:
    """fp32 parameters, drawn in sorted-name order from one
    ``torch.Generator`` seeded with ``seed`` on ``device``.  The numbers
    differ from the reference's ``jax.random`` draws for the same seed
    (same distributions: N(0, (scale / sqrt(fan_in))^2), ones, zeros); to
    run both packages on the same weights, convert the reference's with
    ``weights.params_from_jax``."""
    dev = check_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {name: spec.materialize(gen, dev)
            for name, spec in sorted(specs.items())}


def abstract_params(specs: dict[str, ParamSpec]) -> dict[str, torch.Tensor]:
    """fp32 stand-ins of the parameters on the ``meta`` device (the
    reference's ``ShapeDtypeStruct``s): shapes and dtypes, no storage and
    no draw (``torch.Generator`` takes no ``meta`` device)."""
    return {n: torch.empty(s.shape, dtype=torch.float32, device="meta")
            for n, s in specs.items()}


# ---------------------------------------------------------------------------
# parameters over a mesh
# ---------------------------------------------------------------------------

def shard_params(params: dict[str, torch.Tensor],
                 specs: dict[str, ParamSpec], rules) -> dict[str, Shards]:
    """Each whole leaf split by its logical axes under ``rules``, each
    shard on its home device of ``rules.mesh``."""
    return {k: named_sharding(specs[k].logical, rules).shard(v)
            for k, v in params.items()}


def gather_params(params: dict, device=None) -> dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: whole leaves on ``device`` (plain
    tensors pass through, moved there)."""
    return {k: (v.full(device) if isinstance(v, Shards)
                else v if device is None else v.to(device))
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Upcast to fp32, normalise, multiply by ``scale``, cast back."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def rms_norm_split(x: torch.Tensor, ss: torch.Tensor, n: int,
                   scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``rms_norm`` of one device's part x (..., w) of a last dim of ``n``
    split over devices: ``ss`` (..., 1) is the fp32 sum of squares over
    every part (an all-reduce), ``scale`` this part's."""
    return ((x.float() * torch.rsqrt(ss / n + eps)) * scale.float()
            ).to(x.dtype)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares over the last dim, kept: (..., 1)."""
    x32 = x.float()
    return torch.sum(x32 * x32, dim=-1, keepdim=True)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. x (..., d); w1/w3 (d, f); w2 (f, d).  ``w3`` is the
    gate: ``silu(x @ w3) * (x @ w1)``."""
    h = x @ w1.to(x.dtype)
    g = x @ w3.to(x.dtype)
    h = F.silu(g) * h
    # each device already holds its act_ff columns (w1 / w3 split by
    # columns): the reference's constraint, a no-op inside a shard
    h = constrain(h, *(("act_batch",) + (None,) * (h.dim() - 2)
                       + ("act_ff",)))
    return h @ w2.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); pos: (..., S) int positions.  Rotates the split
    halves (not interleaved pairs) in fp32 and casts back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    angles = pos[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE in fp32. labels < 0 are masked. Returns (loss, n_tok)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    n = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll) / n, n
