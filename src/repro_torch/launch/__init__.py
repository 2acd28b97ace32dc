"""Launchers of the port (twin of ``src/repro/launch``): the LM mode of
``serve``, ``train`` and the work-stealing MBE launcher ``mbe_run``."""
