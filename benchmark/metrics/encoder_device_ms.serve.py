"""Device milliseconds a batch of the resnet encoder (the feature
extractor, models/horizonnet.py): a stage of the captured serving
program, timed between the event-record nodes at its bounds (the
program's ``device.encoder`` spans, utils/profiling.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "encoder")
