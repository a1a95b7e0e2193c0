"""Host milliseconds a batch of ``augment_batch`'s upload of the pixels
and of the five parameter vectors, on the prefetch thread (the
program's ``augment.upload`` spans)."""

from harness.program_spans import ms_a_built_batch


def read(run):
    return ms_a_built_batch(run, "augment.upload")
