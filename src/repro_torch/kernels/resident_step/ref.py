"""Plain torch-op version of the resident segment.

Twin of ``src/repro/kernels/resident_step/ref.py``: ``steps_per_call``
guarded applications of the dense engine's torch-op step under the run
loop's done/budget predicate.  Equality of the kernel with this function
IS equality with the torch-op engine, which the CPU tests hold to the JAX
package leaf for leaf.
"""
from __future__ import annotations

import dataclasses


def resident_segment_ref(g, cfg, s, *, start, budget,
                         steps_per_call: int = 1):
    """Advance ``s`` by up to ``steps_per_call`` guarded torch-op steps."""
    from repro_torch.core import engine_dense as ed

    cfg_jnp = dataclasses.replace(cfg, kernel_impl="jnp")
    return ed.guarded_steps(g, cfg_jnp, s, start=start, budget=budget,
                            n_steps=steps_per_call)
