"""Device milliseconds a step of the depth and ratio head and the loss,
forward and backward: from the transformer's forward end to the gradient
reaching its output (the program's ``device.head_loss`` spans,
models/lgt.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "head_loss")
