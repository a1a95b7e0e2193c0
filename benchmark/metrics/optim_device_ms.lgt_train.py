"""Device milliseconds a step of the Adam update over every parameter
(the program's ``device.optim`` spans, train/step.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "optim")
