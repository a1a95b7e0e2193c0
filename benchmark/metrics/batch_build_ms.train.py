"""Host milliseconds a train batch takes to build on the prefetch thread
(augment_batch with its upload and warp, then the labels), as the
benchmark's span around it times it."""


def read(run):
    t = run.span_seconds("batch_build")
    return 1e3 * sum(t) / len(t) if t else None
