"""Host milliseconds a batch of the host labels, the boundary trace and
the corner heat map of each pano (the program's ``labels.bon`` and
``labels.cor`` spans, geometry/lines.py::cor_2_1d and
data/labels.py::corner_heatmap)."""

from harness.program_spans import ms_a_built_batch


def read(run):
    return ms_a_built_batch(run, "labels.bon", "labels.cor")
