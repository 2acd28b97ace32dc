"""The LM stack of the port (dense family): config, layers, attention and
the model assembly.  Twins of ``src/repro/models/``."""
