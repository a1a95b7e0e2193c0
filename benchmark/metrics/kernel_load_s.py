"""Seconds the process spent building and loading the kernel libraries
(the program's ``build.kernel`` spans, ops/_build.py, recorded always:
nvcc where the checkout has no build of the source, else the load)."""

from harness.program_spans import process_spans, seconds


def read(run):
    spans = process_spans("build.kernel")
    return None if spans is None else seconds(spans)
