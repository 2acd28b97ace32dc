"""Training and serving steps of the LM stack (twin of
``src/repro/training``): the loss, AdamW, the train / eval steps, the
prefill / decode steps, and the int8 gradient codec."""
