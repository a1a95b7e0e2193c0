"""What the per-layer metrics read from the program's own spans and
counters (horizonnet_tpu_torch/utils/profiling.py, ops/launch_counts.py).

A ``--trace 1`` run opens a torch.profiler session over its window, which
turns the program's tracing on; the spans of work done once a process
(``program.capture``, ``build.kernel``) are recorded always. Each reader
returns None where the program records no spans (a program without the
recorder), so its metric is left out of the result line.
"""

import threading


def _reader():
    try:
        from horizonnet_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "spans", None)


def window_spans(run, *names):
    """The program's spans named ``names`` that start inside the traced
    window, or None."""
    read = _reader()
    if read is None:
        return None
    return [s for s in read(run.t0, run.t1) if s.name in names]


def process_spans(name):
    """Every span ``name`` the process recorded, or None."""
    read = _reader()
    if read is None:
        return None
    return [s for s in read() if s.name == name]


def seconds(spans):
    return sum(s.end - s.start for s in spans) / 1e9


def batches(run):
    """The batches the window ran: the captured program's replays
    (``program.replays`` over the window), or where the program ran
    eagerly (the CPU) the batches served in the window; None where the
    program has no such counter."""
    replays = run.launches.get("program.replays")
    if replays is None:
        return None
    return replays or run.driver.attempted // run.driver.B


def ms_a_batch(run, *names, main_thread=False):
    """Host (or device) milliseconds a batch of the spans ``names`` inside
    the window (only the main thread's with ``main_thread``), or None."""
    spans = window_spans(run, *names)
    n = batches(run)
    if spans is None or not n:
        return None
    if main_thread:
        spans = on_main_thread(spans)
    return 1e3 * seconds(spans) / n


def on_main_thread(spans):
    main = threading.main_thread().ident
    return [s for s in spans if s.thread == main]


def stage_ms(run, stage):
    """Device milliseconds a batch of the serving program's ``stage``
    (its ``device.<stage>`` spans), or None where no replay recorded its
    stages (the eager program on the CPU)."""
    spans = window_spans(run, "device." + stage)
    if not spans:
        return None
    return ms_a_batch(run, "device." + stage)


def ms_a_built_batch(run, *names):
    """Host milliseconds of the spans ``names`` inside the window, a batch
    that ``augment_batch`` uploaded there, or None."""
    built = window_spans(run, "augment.upload")
    spans = window_spans(run, *names)
    if not built:
        return None
    return 1e3 * seconds(spans) / len(built)
