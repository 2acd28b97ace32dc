"""Serving steps of the LM stack (twin of ``src/repro/training``); the
loss and the train step come with the training slice (ROADMAP Queue 2)."""
