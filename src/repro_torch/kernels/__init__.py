"""Kernels of the port: each package holds ops wrappers (each launches a
hand-written CUDA kernel on a CUDA tensor, the plain version on a CPU one,
and counts its own launches) and their plain torch-op versions
(``ref.py``).  The CUDA sources live in ``repro_torch/csrc`` and are built
on first use (``_build``).

  fused_check     — counts + Q-violation flag + full/partial/nz flags in
                    one pass, packed, dense and prefix2 activity, rows
                    direct or read through an index vector
                    (``csrc/fused_check.cu``; K1 and the K1 half of K6)
  fused_select    — counts + first masked argmin, dense, packed and prefix
                    activity, rows direct or through an index vector
                    (``csrc/fused_select.cu``; K4 and the K4 half of K6)
  intersect_count — popcount(adj & mask) per row, direct or through an
                    index vector (``csrc/intersect_count.cu``; K5)
  resident_step   — one lane advanced ``steps_per_call`` engine steps per
                    launch (``csrc/resident_step.cu``; K2)
  resident_pool   — the same lane body over a grid of lanes, plus the
                    scoreboard (``csrc/resident_pool.cu``; K3)
  flash_attention — the flash-attention forward, o and lse, bf16 on the
                    tensor cores or fp32 (``csrc/flash_fwd.cu``; K7 fwd)
"""
from repro_torch.kernels.dispatch import resolve_impl  # noqa: F401
