"""The program's counters, in one registry: kernel launches and host
events.

Each kernel wrapper module keeps its launch count as a module global
(``cuda_lstm.launches`` and the like), which adds one where the wrapper
launches its kernel, and registers it here when it is imported. A captured
program (program.py::CapturedProgram) reads every registered launch count
around its capture and adds the captured launches on each replay, so a
wrapper is counted through replays without program.py knowing which
kernels exist. Host counters (``program.replays``, ``program.captures``)
are registered apart with ``host=True``: a replay never adds them again.
"""

import sys

#: (module name, attribute) of every registered kernel launch count
COUNTS = []
#: (module name, attribute) of every registered host counter
HOST = []


def register(module_name, attr, host=False):
    """Register the count ``attr`` of module ``module_name`` (a host
    counter with ``host``)."""
    into = HOST if host else COUNTS
    if (module_name, attr) not in into:
        into.append((module_name, attr))


def read():
    """{(module name, attribute): count} of every registered kernel launch
    count."""
    return {k: getattr(sys.modules[k[0]], k[1]) for k in COUNTS}


def write(counts):
    """Set the counts of ``counts`` ({(module name, attribute): count})."""
    for (m, a), n in counts.items():
        setattr(sys.modules[m], a, n)


def reset():
    """Set every registered count to 0."""
    write(dict.fromkeys(COUNTS + HOST, 0))


def named():
    """{"<module>.<attribute>": count} of every registered count, host
    counters too, by the module's last name (e.g. "cuda_lstm.launches",
    "program.replays")."""
    return {f"{m.rsplit('.', 1)[1]}.{a}": getattr(sys.modules[m], a)
            for m, a in COUNTS + HOST}
