#!/usr/bin/env python3
"""The highest rate an open-loop serving cell sustains, by a sweep.

    python3 benchmark/tools/sweep_rate.py --workload st3d-latency-b1 \
        --seed 1 --seconds 8 --rates 60 80 100 120

Sets the cell up once, then for each offered rate runs the cell's window
at that rate and prints one JSON line: the requests, the latency's p50,
p95 and p99 (ms, from when each was due), how late the feed handed
requests on, and the mean latency of the window's last tenth over its
first tenth: a backlog that grows through the window reads well above 1.
First it serves single panos back to back (``closed``), the rate no
offered load can exceed. The cell's ``rate_per_s`` is set, once, at
about four fifths of the highest rate whose backlog does not grow.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def main(argv):
    import numpy as np
    import torch

    from harness.cell import load_cell
    from harness.kinds.open_loop_serve import Driver
    from harness.trace import Spans

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    d = Driver(cell, a.seed, torch.device("cuda", 0), Spans())
    d.setup()
    n = len(d.rows)
    t0 = time.perf_counter()
    done = d.stream([[i % n] for i in range(int(200 * a.seconds) // 4)])
    rate = len(done) / (time.perf_counter() - t0)
    print(json.dumps({"closed_loop_per_s": rate}), flush=True)
    for r in a.rates:
        d.rate = r
        d.window(a.seconds)
        lat = np.array(d.latencies)
        k = max(1, len(lat) // 10)
        print(json.dumps({
            "rate_per_s": r, "requests": len(lat),
            "p50_ms": float(np.median(lat)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "feed_late_p95_ms": float(1e3 * np.quantile(d.late, 0.95)),
            "last_over_first_tenth": float(lat[-k:].mean()
                                           / lat[:k].mean())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
