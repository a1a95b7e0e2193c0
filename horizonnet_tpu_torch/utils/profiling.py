"""Per-stage wall-clock timing and torch.profiler trace hooks.

Copied from horizonnet_tpu/utils/profiling.py: ``stage_timer`` accumulates
wall-clock per named stage (the preprocess pipeline's stages, reported by
its CLI's ``--profile``). The CLI times stages from a pool of threads,
so each update is made under a lock. ``trace_annotation`` opens a
``torch.profiler.record_function`` span, so that stages show up in the
traces of ``trace_profile`` (the inference CLI's ``--profile_dir``).
"""

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self):
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        lines = []
        for name in sorted(totals, key=totals.get, reverse=True):
            t, n = totals[name], counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t/n*1000:.1f} ms/call "
                         f"({n} calls)")
        return "\n".join(lines)


stage_timer = StageTimer()


def trace_annotation(name):
    """A named span in the running torch.profiler trace (none without
    one)."""
    import torch

    return torch.profiler.record_function(name)


def trace_profile(device, trace_dir=None):
    """A torch.profiler session that records every thread's spans: the
    CPU activity, and the CUDA activity (the kernels) on a CUDA
    ``device`` only; a CPU-only torch build asked for CUDA activity floods
    warnings and stalls. By default the profiler records the spans of the
    thread that started it only, and ``serve_stream`` runs its finish
    tail on worker threads; ``profile_all_threads`` records them too.
    With ``trace_dir`` the session writes a Chrome trace,
    ``<host>_<pid>.<time>.pt.trace.json``, into it when it ends (Perfetto
    and TensorBoard's torch plugin open it)."""
    import torch
    from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                profile, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(
        activities=activities,
        on_trace_ready=(tensorboard_trace_handler(trace_dir)
                        if trace_dir else None),
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
