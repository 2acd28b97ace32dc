"""Flash attention (K7): the forward kernel's ops wrapper and plain
versions.  The backward kernels (K7 dq, dkv) come with the training
path (ROADMAP Queue 2)."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_fwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref, flash_fwd_ref)
