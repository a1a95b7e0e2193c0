"""Host spans, the device trace of a traced run, and what is read from them.

``Spans`` keeps the benchmark's own spans in memory: each call into a
layer of the program (``put``, ``run``, ``finish``, ``batch_build``,
``step``) as (name, start ns, end ns, thread id) on the host's
``perf_counter_ns`` clock, written by any thread.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity over a traced
window and turns its records into device operations on the same host
clock: a ``record_function`` anchor taken at a known ``perf_counter_ns``
gives the profiler clock's offset. From them: the busy seconds (the union
of the operations' intervals inside the window), the operations that took
most time, and the idle gaps, each named by the span the host was in at
the gap's middle.
"""

import bisect
import collections
import threading
import time
from contextlib import contextmanager


class Spans:
    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    @contextmanager
    def __call__(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self.records.append((name, t0, t1, threading.get_ident()))

    def named(self, name, t0=None, t1=None):
        """Durations in seconds of the spans ``name`` that start inside
        [t0, t1] (ns; None: any)."""
        return [(b - a) / 1e9 for n, a, b, _ in self.records
                if n == name and (t0 is None or a >= t0)
                and (t1 is None or a <= t1)]


def union_seconds(intervals):
    """Seconds covered by the union of (start ns, end ns) intervals."""
    total, lo, hi = 0, None, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        total += hi - lo
    return total / 1e9


def gaps(intervals, t0, t1):
    """Idle (start ns, end ns) gaps of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


class DeviceTrace:
    """``with DeviceTrace() as tr:`` profiles the device; after the block
    ``tr.ops`` holds (name, start ns, end ns) of every device operation on
    the host clock."""

    def __init__(self):
        self.ops = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.profiler.record_function("bench.anchor"):
            self._anchor = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        time.sleep(0.2)           # the last device records arrive late
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self._prof.events()
        anchor = [e for e in events if e.name == "bench.anchor"]
        offset = (self._anchor - int(anchor[0].time_range.start * 1000)
                  if anchor else 0)
        self.ops = [(e.name, int(e.time_range.start * 1000) + offset,
                     int(e.time_range.end * 1000) + offset)
                    for e in events if e.device_type == DeviceType.CUDA]
        self._prof = None
        return False


def top_ops(ops, n=10):
    """[[name, seconds]] of the ``n`` device operations that took most
    time in all."""
    by = collections.Counter()
    for name, a, b in ops:
        by[name[:120]] += (b - a) / 1e9
    return [[k, v] for k, v in by.most_common(n)]


def idle_by_span(ops, spans, t0, t1, n=10):
    """[[span name, seconds]] of the idle gaps of [t0, t1], largest first.
    Each gap is named by the span that held the main thread at its middle,
    else by one that held another thread ("none" outside every span). The
    spans of one thread are taken as not nested: the latest that started
    before the middle is the one looked at."""
    main = threading.main_thread().ident
    by_thread = collections.defaultdict(list)
    for name, a, b, tid in spans.records:
        by_thread[tid].append((a, b, name))
    order = sorted(by_thread, key=lambda tid: tid != main)
    tables = []
    for tid in order:
        recs = sorted(by_thread[tid])
        tables.append(([r[0] for r in recs], recs))
    by = collections.Counter()
    for a, b in gaps([(x, y) for _, x, y in ops], t0, t1):
        mid, name = (a + b) // 2, "none"
        for starts, recs in tables:
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and recs[i][1] >= mid:
                name = recs[i][2]
                break
        by[name] += (b - a) / 1e9
    return [[k, v] for k, v in by.most_common(n)]
