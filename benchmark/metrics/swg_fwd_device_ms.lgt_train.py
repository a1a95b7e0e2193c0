"""Device milliseconds a step of the SWG-Transformer's forward: the stage
of the captured train step between the event-record nodes at its bounds
(the program's ``device.swg_fwd`` spans, models/lgt.py,
utils/profiling.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "swg_fwd")
