"""The share of the traced window in which no operation ran on the
device (the union of the traced operations' intervals)."""


def read(run):
    return 100.0 * (1.0 - run.busy_s / run.window_s)
