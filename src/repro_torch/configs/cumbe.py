"""The paper's own workload config: one big graph under work stealing.

Twin of ``src/repro/configs/cumbe.py``: the graph-scale class of the
distributed runner (``core.distributed``), pure data.  ``CONFIG`` is the
production cell (|U| = |V| = 16,384: a 16,384 x 512-word adjacency,
32 MiB, shared by every worker); ``SMOKE`` is the reduced cell whose
``workers_per_device`` is ``launch/mbe_run.py``'s default worker count.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.distributed import DistConfig
from repro_torch.core.engine_dense import EngineConfig


@dataclasses.dataclass(frozen=True)
class MBEWorkload:
    name: str
    n_u: int                 # padded |U|
    n_v: int                 # padded |V|
    density: float           # edge density (generator parameter)
    depth: int               # DFS depth bound
    dist: DistConfig = DistConfig()

    def engine_config(self, impl: str = "jnp") -> EngineConfig:
        return EngineConfig(n_u=self.n_u, n_v=self.n_v, m_real=self.n_u,
                            depth=self.depth, impl=impl)


CONFIG = MBEWorkload(
    name="cumbe-16k", n_u=16_384, n_v=16_384, density=2e-3, depth=64,
    dist=DistConfig(steps_per_round=4096, workers_per_device=1),
)

SMOKE = MBEWorkload(
    name="cumbe-smoke", n_u=64, n_v=64, density=0.1, depth=66,
    dist=DistConfig(steps_per_round=256, workers_per_device=2),
)
