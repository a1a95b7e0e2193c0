"""Milliseconds a request in which the device sat idle while the main
thread was inside the captured program's replay (the traced window's idle
gaps intersected with the program's ``program.replay`` spans): the launch
starving the device."""

from harness.program_spans import batches, on_main_thread, window_spans
from harness.trace import gaps


def read(run):
    spans = window_spans(run, "program.replay")
    n = batches(run)
    if spans is None or not n:
        return None
    idle = gaps([(a, b) for _, a, b in run.ops], run.t0, run.t1)
    ns = 0
    for s in on_main_thread(spans):
        ns += sum(max(0, min(b, s.end) - max(a, s.start)) for a, b in idle)
    return ns / 1e6 / n
