"""Flash attention (K7): the forward and backward kernels' ops wrappers,
the autodiff ``flash_attention``, and their plain versions."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_bwd, flash_fwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref, flash_bwd_ref, flash_fwd_ref)
