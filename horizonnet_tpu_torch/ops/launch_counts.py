"""The kernel wrappers' launch counts, in one registry.

Each wrapper module keeps its count as a module global (``cuda_lstm.launches``
and the like), which adds one where the wrapper launches its kernel, and
registers it here when it is imported. A captured program
(program.py::CapturedProgram) reads every registered count around its
capture and adds the captured launches on each replay, so a wrapper is
counted through replays without program.py knowing which kernels exist.
"""

import sys

#: (module name, attribute) of every registered count
COUNTS = []


def register(module_name, attr):
    """Register the count ``attr`` of module ``module_name``."""
    if (module_name, attr) not in COUNTS:
        COUNTS.append((module_name, attr))


def read():
    """{(module name, attribute): count} of every registered count."""
    return {k: getattr(sys.modules[k[0]], k[1]) for k in COUNTS}


def write(counts):
    """Set the counts of ``counts`` ({(module name, attribute): count})."""
    for (m, a), n in counts.items():
        setattr(sys.modules[m], a, n)


def reset():
    """Set every registered count to 0."""
    write(dict.fromkeys(COUNTS, 0))


def named():
    """{"<module>.<attribute>": count} of every registered count, by the
    module's last name (e.g. "cuda_lstm.launches")."""
    return {f"{m.rsplit('.', 1)[1]}.{a}": n for (m, a), n in read().items()}
