"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``moe_ffn``: the same numpy-seeded inputs through both, in fp32.

Tolerances: fp32 1e-5 abs/rel on the output and the aux loss (the same
arithmetic, summed in another order); the routing (which tokens reach
which expert, which overflow capacity) exactly, through the outputs of
tokens that are dropped (0) or kept."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models.moe import moe_ffn as j_moe_ffn
from repro_torch.models.moe import moe_ffn, top_k_lower_first


def _weights(d, E, f, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) / np.sqrt(s[-2])
            for s in ((d, E), (E, d, f), (E, d, f), (E, f, d))]


def _both(x, ws, **kw):
    jo, ja = j_moe_ffn(jnp.asarray(x), *map(jnp.asarray, ws), **kw)
    to, ta = moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws), **kw)
    return (np.asarray(jo), float(ja)), (to.numpy(), float(ta))


# (B, S, d, E, f, top_k, capacity_factor, group): a group per sequence,
# one group of all tokens, a group of one token (the served decode), and
# capacity overflow (capacity factor 0.25: most tokens dropped)
CASES = [
    (2, 16, 32, 8, 16, 2, 1.25, 16),
    (2, 16, 32, 8, 16, 2, 1.25, 64),
    (4, 1, 32, 8, 16, 2, 1.25, 1),
    (2, 16, 32, 8, 16, 2, 0.25, 16),
    (1, 24, 16, 4, 8, 3, 1.0, 8),
]


@pytest.mark.parametrize("B,S,d,E,f,k,cf,group", CASES)
def test_moe_ffn_matches_jax(B, S, d, E, f, k, cf, group):
    x = np.random.default_rng(B * S + E).normal(size=(B, S, d)).astype(
        np.float32)
    ws = _weights(d, E, f, seed=group)
    (jo, ja), (to, ta) = _both(x, ws, top_k=k, capacity_factor=cf,
                               group=group)
    assert to.shape == (B, S, d)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)
    if cf < 1:          # overflow: the same tokens lose every expert
        dropped_j = np.all(np.abs(jo) < 1e-12, axis=-1)
        dropped_t = np.all(np.abs(to) < 1e-12, axis=-1)
        assert dropped_j.any() and np.array_equal(dropped_j, dropped_t)


def test_capacity_overflow_drops_the_later_tokens():
    """Every token routed to the same experts (a router that ignores x):
    with capacity C only the first C tokens of a group get an output, in
    both packages."""
    B, S, d, E, f, k = 1, 8, 16, 4, 8, 1
    x = np.abs(np.random.default_rng(3).normal(size=(B, S, d))).astype(
        np.float32) + 0.1
    ws = _weights(d, E, f, seed=4)
    ws[0] = np.zeros((d, E), np.float32)
    ws[0][:, 2] = 1.0                    # expert 2 wins for every token
    (jo, ja), (to, ta) = _both(x, ws, top_k=k, capacity_factor=1.0,
                               group=8)
    C = int(8 * 1 * 1.0 / E + 1)         # 3
    kept = np.any(np.abs(to[0]) > 0, axis=-1)
    assert kept.tolist() == [True] * C + [False] * (S - C)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)


def test_router_tie_goes_to_the_lower_expert():
    """A router with all logits equal: top-k takes experts 0 .. k-1, as
    ``jax.lax.top_k`` does; the outputs then match expert for expert."""
    B, S, d, E, f, k = 2, 4, 16, 8, 8, 2
    x = np.random.default_rng(5).normal(size=(B, S, d)).astype(np.float32)
    ws = _weights(d, E, f, seed=6)
    ws[0] = np.zeros((d, E), np.float32)
    (jo, ja), (to, ta) = _both(x, ws, top_k=k, capacity_factor=8.0,
                               group=8)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)
    # the same function with experts 0 and 1 swapped differs: the tie
    # really picked by index
    ws2 = list(ws)
    for i in (1, 2, 3):
        ws2[i] = ws[i][[1, 0] + list(range(2, E))]
    swapped, _ = moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws2),
                         top_k=1, capacity_factor=8.0, group=8)
    first, _ = moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws),
                       top_k=1, capacity_factor=8.0, group=8)
    assert not torch.allclose(swapped, first)


@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_lower_first_matches_lax_top_k(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, size=(6, 10)).astype(np.float32)   # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = top_k_lower_first(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
