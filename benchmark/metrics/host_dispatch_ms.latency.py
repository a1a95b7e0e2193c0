"""Host milliseconds a request spends in the engine's ``put`` (pinned
staging, the upload on the copy stream) and ``run`` (the replay of the
captured program), as the benchmark's proxy engine times them."""


def read(run):
    put, run_ = run.span_seconds("put"), run.span_seconds("run")
    if not run_:
        return None
    return 1e3 * (sum(put) + sum(run_)) / len(run_)
