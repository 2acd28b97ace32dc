"""The training of the moe, vlm, audio, hybrid and ssm families in the port
(``repro_torch.training.step.loss_fn``, the models under autograd)
against the JAX package's, on each family's smoke config in fp32 with the
same weights and numpy-seeded tokens, labels, patch rows and codebooks
(``tests/_train_families.py``): the loss total and metrics rtol 1e-5,
every grad leaf rtol 1e-3 / atol 1e-5 of ``jax.value_and_grad``, through
the torch-op attention ("xla") and through K7 ("pallas": the JAX side's
Pallas kernel in interpret mode, the port's plain versions)."""
import pytest

import _train_families as F


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", F.ARCHS)
def test_loss_and_grads_match(arch, impl):
    m = F.grads_match(arch, impl)
    c = F.cfg(arch)
    assert m["tokens"] == 2 * 31 * (c.n_codebooks or 1)   # vlm: text only
    if c.family == "moe":
        assert m["aux_loss"] > 0             # summed over the layers
