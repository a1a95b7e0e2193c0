"""Device milliseconds a batch of the head: the height stage, the bi-LSTM
on K1, the linear layer and the TTA mean: a stage of the captured
serving program, timed between the event-record nodes at its bounds (the
program's ``device.head`` spans, utils/profiling.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "head")
