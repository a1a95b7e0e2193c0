"""Seconds the process spent warming up and capturing its programs as
CUDA graphs (the program's ``program.capture`` spans,
program.py::CapturedProgram, recorded always), less the kernel builds and
loads that the warm-up set off (``build.kernel`` spans inside them, which
``kernel_load_s`` counts); read where the spans number the program's
``program.captures`` counter."""

from harness.program_spans import process_spans, seconds


def read(run):
    from horizonnet_tpu_torch.ops import launch_counts

    spans = process_spans("program.capture")
    if spans is None or len(spans) != launch_counts.named().get(
            "program.captures"):
        return None
    builds = [s for s in process_spans("build.kernel")
              if s.parent == "program.capture"]
    return seconds(spans) - seconds(builds)
