"""Device milliseconds a step of the resnet50 encoder and height stage,
forward and backward: the captured train step's ``device.encoder_fwd``
and ``device.encoder_bwd`` spans (models/lgt.py, train/step.py)."""

from harness.program_spans import stage_ms


def read(run):
    fwd, bwd = stage_ms(run, "encoder_fwd"), stage_ms(run, "encoder_bwd")
    return None if fwd is None or bwd is None else fwd + bwd
