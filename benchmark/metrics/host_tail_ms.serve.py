"""Host milliseconds a batch spends in the serving tail on the worker
thread (the fetch of the packed fit and finish_general_batch), as the
benchmark's finish wrapper times it."""


def read(run):
    t = run.span_seconds("finish")
    return 1e3 * sum(t) / len(t) if t else None
