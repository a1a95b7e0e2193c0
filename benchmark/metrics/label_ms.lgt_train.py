"""Host milliseconds a batch of LGT-Net's labels, the horizon depths and
ratio of each pano (the program's ``labels.depth`` spans,
data/labels.py::horizon_depth)."""

from harness.program_spans import ms_a_built_batch


def read(run):
    return ms_a_built_batch(run, "labels.depth")
