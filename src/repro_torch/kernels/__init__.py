"""Kernels of the port: each package holds an ops wrapper (launches the
hand-written CUDA kernel on a CUDA tensor, the plain version on a CPU
one) and its plain torch-op version (``ref.py``).  The CUDA sources live
in ``repro_torch/csrc`` and are built on first use (``_build``).

  fused_check     — counts + Q-violation flag + packed full/partial/nz
                    words in one pass (``csrc/fused_check.cu``)
  resident_step   — one lane advanced ``steps_per_call`` engine steps per
                    launch (``csrc/resident_step.cu``)
  resident_pool   — the same lane body over a grid of lanes, plus the
                    scoreboard (``csrc/resident_pool.cu``)
  fused_select,
  intersect_count — plain versions only; their CUDA kernels are still to
                    port (ROADMAP Queue 2 K4, K5) and raise on a CUDA
                    tensor
"""
from repro_torch.kernels.dispatch import resolve_impl  # noqa: F401
