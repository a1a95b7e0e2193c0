"""Host milliseconds a batch the tail worker waits for the device to write
the batch's outputs (the program's ``serve.wait_written`` spans)."""

from harness.program_spans import ms_a_batch


def read(run):
    return ms_a_batch(run, "serve.wait_written")
