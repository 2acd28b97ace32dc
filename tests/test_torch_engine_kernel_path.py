"""The port's dense-engine KERNEL path (``kernel_impl="pallas"`` on CPU
tensors, where every ops wrapper runs its plain version) against the JAX
package's Pallas kernels in interpret mode, leaf for leaf at every
segment boundary: ``resident=True`` (the resident segment, which writes
fresh counts into ``cstack`` on descent in every order mode) and
``resident=False`` (the per-step ``fused_check`` path, which writes zero
``cstack`` rows outside ``deg``).  Tolerance: exact."""
import pytest
import torch

from repro_torch.core import engine_dense as ted
from test_torch_engine_dense import T_GRAPHS, _lockstep, _oracle


@pytest.mark.parametrize("name,mode,resident", [
    ("corp-leadership", "deg", True), ("corp-leadership", "input", True),
    ("corp-leadership", "deg", False),
    ("corp-leadership", "deg_nocache", False),
    ("corp-leadership", "input", False),
    ("unicode-like", "deg_nocache", True), ("unicode-like", "input", False)])
def test_leaves_match_jax_pallas_interpret(name, mode, resident):
    g, s = _lockstep(name, seg_steps=30, unroll=2, order_mode=mode,
                     kernel_impl="pallas", resident=resident)
    assert (int(s.n_max), int(s.cs) % (1 << 32)) == _oracle(g)



def test_per_step_kernel_path_zero_cstack_outside_deg():
    """With residency off the kernel path writes zero cstack rows in
    'input' mode, the torch-op path the fresh counts: same counters,
    different cstack leaf."""
    g = T_GRAPHS["ucforum-like"]
    a = ted.enumerate_dense(g, order_mode="input", kernel_impl="pallas",
                            resident=False, device="cpu")
    b = ted.enumerate_dense(g, order_mode="input", kernel_impl="jnp",
                            device="cpu")
    assert int(a.n_max) == int(b.n_max) and int(a.cs) == int(b.cs)
    assert int(a.steps) == int(b.steps)
    assert not torch.equal(a.cstack, b.cstack)
