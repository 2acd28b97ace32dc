"""Step-indexed data pipeline (copy of ``src/repro/datapipe``)."""
from repro_torch.datapipe.pipeline import (  # noqa: F401
    DataConfig, MemmapSource, SyntheticSource, make_pipeline)
