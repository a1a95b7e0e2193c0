"""Device milliseconds a batch of the dct4 wire's decode
(inference.py::decode_wire): a stage of the captured serving program,
timed between the event-record nodes at its bounds (the program's
``device.decode`` spans, utils/profiling.py)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "decode")
