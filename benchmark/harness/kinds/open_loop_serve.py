"""Single-pano requests arriving on their own schedule (an open loop): an
app where each user uploads one pano and waits for its layout.

Traffic parameters: ``batch`` (1), ``depth``, ``tail_workers``,
``distinct_panos`` (rolled panos drawn from the seed; each request takes
one of them, drawn from the seed), ``rate_per_s`` (the offered rate),
``trace_seconds``.

Arrivals are a Poisson process at ``rate_per_s``: N = rate x seconds
requests with independent exponential gaps drawn from the seed. Every
distinct pano is asked for equally often, in an order drawn from the
seed, so a seed changes when requests come and not what they ask.

``latency_p95_ms``: the 95th percentile over every request of the window
of the time from when it was due to the end of its ``finish`` on the
worker thread (a failed request counts as infinitely late). How late the
feed handed requests on is printed on an earlier line.
"""

import sys
import time

import numpy as np

from harness.serving import Serving


def arrival_gaps(rate, n, rng):
    """``n`` independent exponential gaps (seconds) at ``rate``."""
    return rng.exponential(1.0 / rate, n)


def balanced_picks(n, n_rows, rng):
    """``n`` row indices, each row as often as the others (to one), in an
    order drawn from ``rng``."""
    return rng.permutation(np.arange(n) % n_rows)


class Driver(Serving):
    def setup(self):
        t = self.cell.traffic
        if self.B != 1:
            raise ValueError("an open-loop request is one pano")
        self.make_rows(t["distinct_panos"])
        self.rate = float(t["rate_per_s"])
        self.build()
        # warm-up: every distinct pano once, back to back
        reqs = [[i] for i in range(len(self.rows))]
        if any(r is None for _, r in self.stream(reqs)):
            raise RuntimeError(f"warm-up failed: {self.errors}")

    def window(self, seconds):
        n = max(1, int(round(self.rate * seconds)))
        gaps = arrival_gaps(self.rate, n, self.rng)
        picks = balanced_picks(n, len(self.rows), self.rng)
        due = np.zeros(n, np.int64)
        late = np.zeros(n)

        def requests():
            self.t0 = time.perf_counter_ns()
            due[:] = self.t0 + np.cumsum((gaps * 1e9).astype(np.int64))
            for i in range(n):
                wait = (due[i] - time.perf_counter_ns()) / 1e9
                if wait > 0:
                    with self.spans("arrival"):
                        time.sleep(wait)
                late[i] = max(0.0, -wait)
                yield [int(picks[i])]

        done = self.stream(requests())
        self.t1 = max(t for t, _ in done)
        lat = np.array([(t - d) / 1e6 if res is not None else np.inf
                        for (t, res), d in zip(done, due)])
        self.served = [(int(picks[i]), res[0])
                       for i, (_, res) in enumerate(done) if res is not None]
        self.attempted, self.panos = n, n
        self.latencies, self.late = lat, late
        self.failed = int(np.sum(~np.isfinite(lat)))
        print(f"open loop: {n} requests at {self.rate} /s over "
              f"{(due[-1] - self.t0) / 1e9:.3f} s; feed late p50 "
              f"{1e3 * np.median(late):.3f} ms, p95 "
              f"{1e3 * np.quantile(late, 0.95):.3f} ms, max "
              f"{1e3 * late.max():.3f} ms; latency p50 "
              f"{np.median(lat):.3f} ms", file=sys.stderr)
        return {"latency_p95_ms": float(np.percentile(
            lat, 95, method="inverted_cdf"))}
