"""Host milliseconds a request spends in the captured program's replay:
the graph launch and the launch-count bookkeeping (the program's
``program.replay`` spans on the main thread)."""

from harness.program_spans import ms_a_batch


def read(run):
    return ms_a_batch(run, "program.replay", main_thread=True)
