"""The port's span recorder, and torch.profiler trace sessions.

``span(name, req=None)`` is a context manager that records ``Span(name,
start ns, end ns, thread id, parent, request id, note)`` on the clock of
``time.perf_counter_ns``: the parent is the name of the enclosing span on
the same thread, and the request id is inherited from the enclosing span,
or from a ``request(req)`` block, where none is given. Records are kept in
memory, at most ``MAX_SPANS`` of them (the oldest go first); ``spans(t0,
t1)`` returns those that start inside [t0, t1], ``report()`` sums them by
name (the preprocess CLI's ``--profile``), ``clear()`` empties them.

Tracing is on while ``enable()`` is in force or while a torch.profiler
session is open anywhere in the process (the process-wide flag
``torch.autograd.profiler._is_profiler_enabled``, which worker threads
see too; the per-thread ``_profiler_enabled()`` reads False on them).
Off, a span is one shared no-op context. While a profiler session is open
a span also opens ``record_function(name)``, so the session's Chrome
trace (``trace_profile``, the inference CLI's ``--profile_dir``) shows it.
A span opened with ``always=True`` is recorded on or off: work done once
a process, such as a kernel library's build (``build.kernel``) and a
program's capture (``program.capture``).

Device stages: a captured program (program.py::CapturedProgram) that
calls ``mark(name)`` at its stage boundaries gets an event-record node at
each (``mark_backward(x, name)`` marks where the backward pass reaches
``x``, from autograd's own thread); while tracing is on, each replay's
nodes record into events of its own, and the time between two marks
becomes a device span
``device.<name>`` (its start is the replay's host start, its length the
device's), resolved without blocking once the replay has finished
(``resolve()``, called by serve_stream's tail workers and by ``spans``).
"""

import collections
import threading
import time

import torch.autograd as _autograd
import torch.autograd.profiler as _autograd_profiler

#: records kept; the oldest are dropped beyond
MAX_SPANS = 1 << 18

Span = collections.namedtuple(
    "Span", "name start end thread parent req note")

#: thread id of the device spans
DEVICE = 0

_enabled = False
_records = collections.deque(maxlen=MAX_SPANS)
_local = threading.local()
_pending = collections.deque()   # (replay's start ns, req, names, events,
_pending_lock = threading.Lock()  # release) of device stages not yet read


class _Enabled:
    __slots__ = ("prev",)

    def __init__(self, prev):
        self.prev = prev

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled = self.prev
        return False


def enable(on=True):
    """Turn tracing on (or, with ``on=False``, off unless a profiler
    session keeps it on). Used in a ``with`` statement, the previous state
    comes back at the block's end."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return _Enabled(prev)


def _stack():
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "req", "note", "t0", "parent", "_fn")

    def __init__(self, name, req, note):
        self.name, self.req, self.note = name, req, note

    def __enter__(self):
        stack = _stack()
        self.parent = None
        for frame in reversed(stack):
            if self.parent is None and frame.name is not None:
                self.parent = frame.name
            if self.req is None:
                self.req = frame.req
            if self.parent is not None and self.req is not None:
                break
        stack.append(self)
        self._fn = None
        if self.name is not None and _autograd_profiler._is_profiler_enabled:
            self._fn = _autograd_profiler.record_function(self.name)
            self._fn.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _stack().pop()
        if self.name is not None:
            _records.append(Span(self.name, self.t0, t1,
                                 threading.get_ident(), self.parent,
                                 self.req, self.note))
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name, req=None, note=None, always=False):
    """Record the block as span ``name`` (request id ``req``, a ``note``
    such as what a build did) while tracing is on, or always."""
    if always or _enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name, req, note)
    return _NO_SPAN


def request(req):
    """Spans opened inside the block on this thread take request id
    ``req`` where they give none; nothing is recorded for the block."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(None, req, None)
    return _NO_SPAN


def spans(t0=None, t1=None):
    """The recorded spans that start inside [t0, t1] (ns; None: open),
    device stages of finished replays included."""
    resolve()
    return [s for s in list(_records)
            if (t0 is None or s.start >= t0) and (t1 is None or s.start <= t1)]


def clear():
    """Forget every recorded span."""
    _records.clear()


def report(t0=None, t1=None):
    """The recorded spans summed by name, largest total first: one line
    each, ``name: total s, ms a call (calls)``."""
    totals, counts = collections.defaultdict(int), collections.Counter()
    for s in spans(t0, t1):
        totals[s.name] += s.end - s.start
        counts[s.name] += 1
    return "\n".join(
        f"{name}: {t / 1e9:.3f}s total, {t / counts[name] / 1e6:.1f} "
        f"ms/call ({counts[name]} calls)"
        for name, t in sorted(totals.items(), key=lambda kv: -kv[1]))


# device stages of captured programs ------------------------------------

def mark(name):
    """The end of device stage ``name`` (``None``: the start of the first)
    inside a program that a CapturedProgram is capturing; a no-op on any
    other call. A mark made by the backward pass (``mark_backward``) runs
    on autograd's device thread, not on the capturing one: it reaches the
    capture's list through ``_capturing``, when that thread's current
    stream is the capture's."""
    marks = getattr(_local, "marks", None)
    if marks is None:
        marks = _capturing[0]
    if marks is not None:
        import torch

        if torch.cuda.is_current_stream_capturing():
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            marks.append((name, ev))


def collect_marks(marks):
    """Let ``mark`` append (name, event) to ``marks`` on this thread, and
    from the threads that run its backward passes (``None``: stop)."""
    _local.marks = marks
    _capturing[0] = marks


#: the mark list of the capture in progress, for autograd's threads
_capturing = [None]


class _MarkBackward(_autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mark(ctx.name)
        return grad, None


def mark_backward(x, name):
    """``x`` as it is, with ``mark(name)`` made where the backward pass
    has computed the gradient of ``x``: the end of the backward stage that
    leads there. ``x`` that needs no gradient is returned alone."""
    if not x.requires_grad:
        return x
    return _MarkBackward.apply(x, name)


def add_device_stages(t0, req, names, events, release):
    """A replay started at host ns ``t0`` records ``events`` at its stage
    boundaries: stage ``names[i]`` runs from ``events[i]`` to
    ``events[i + 1]``. ``release(events)`` takes them back once read."""
    with _pending_lock:
        _pending.append((t0, req, names, events, release))


def resolve():
    """Turn the device stages of every finished replay into spans,
    without waiting for the device."""
    while True:
        with _pending_lock:
            if not _pending or not _pending[0][3][-1].query():
                return
            t0, req, names, events, release = _pending.popleft()
        for name, a, b in zip(names, events, events[1:]):
            ns = int(a.elapsed_time(b) * 1e6)
            _records.append(Span("device." + name, t0, t0 + ns, DEVICE,
                                 None, req, None))
        release(events)


def pending():
    """Replays whose device stages are not read yet."""
    return len(_pending)


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
