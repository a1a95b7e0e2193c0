"""Host milliseconds a batch the main thread of ``serve_stream`` waits for
the oldest result, so that the tail paces the feed (the program's
``serve.wait_result`` spans)."""

from harness.program_spans import ms_a_batch


def read(run):
    return ms_a_batch(run, "serve.wait_result")
