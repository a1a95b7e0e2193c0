"""Host milliseconds a request waits in the engine's ``put`` for its
upload slot's previous copy to leave the pinned staging buffer (the
program's ``upload.slot_wait`` spans, program.py::UploadRing)."""

from harness.program_spans import ms_a_batch


def read(run):
    return ms_a_batch(run, "upload.slot_wait")
