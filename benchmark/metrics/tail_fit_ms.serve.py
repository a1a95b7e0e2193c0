"""Host milliseconds a batch of the general tail's numpy fit on the worker,
the fetch left out (the program's ``tail.general`` spans,
postproc/serving.py::finish_general_batch)."""

from harness.program_spans import ms_a_batch


def read(run):
    return ms_a_batch(run, "tail.general")
