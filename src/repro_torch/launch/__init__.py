"""Launchers of the port (twin of ``src/repro/launch``): the LM mode of
``serve``."""
