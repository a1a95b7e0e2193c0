"""The benchmark's tests run on the CPU at small sizes:
``python -m pytest benchmark/tests -q`` from the repository's root."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
