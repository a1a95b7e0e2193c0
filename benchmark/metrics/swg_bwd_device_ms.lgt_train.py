"""Device milliseconds a step of the SWG-Transformer's backward: from the
gradient reaching the transformer's output to its leaving the input, both
marked from the backward pass (the program's ``device.swg_bwd`` spans,
models/lgt.py, utils/profiling.py::mark_backward)."""

from harness.program_spans import stage_ms


def read(run):
    return stage_ms(run, "swg_bwd")
