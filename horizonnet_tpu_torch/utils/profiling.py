"""Per-stage wall-clock timing.

Copied from horizonnet_tpu/utils/profiling.py: ``stage_timer`` accumulates
wall-clock per named stage (the preprocess pipeline's stages, reported by
its CLI's ``--profile``). The CLI times stages from a pool of threads,
so each update is made under a lock.
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
