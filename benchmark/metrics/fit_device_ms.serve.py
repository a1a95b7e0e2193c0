"""Device milliseconds a batch of the general fit on the device
(postprocess_general_batch) and the packing: a stage of the captured
serving program, timed between the event-record nodes at its bounds (the
program's ``device.fit`` spans, utils/profiling.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "fit")
