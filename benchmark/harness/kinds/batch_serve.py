"""Offline batch serving: full batches back to back, as fast as the
program takes them (a closed loop of depth ``depth``).

Traffic parameters: ``batch``, ``depth``, ``tail_workers``,
``distinct_batches`` (batches of rolled panos drawn from the seed; the
window sends them in turn), ``trace_seconds`` (the traced run's window).

``serve_panos_per_s``: the panos of every batch sent in the window, over
the seconds from the first ``put`` to the last result on the host.
"""

import time

from harness.serving import Serving


class Driver(Serving):
    def setup(self):
        t = self.cell.traffic
        self.n_distinct = t["distinct_batches"]
        self.make_rows(self.n_distinct * self.B)
        self.build()
        # warm-up: the whole path, every distinct batch, twice
        reqs = [self._batch(k) for k in range(2 * self.n_distinct)]
        if any(r is None for _, r in self.stream(reqs)):
            raise RuntimeError(f"warm-up failed: {self.errors}")

    def _batch(self, k):
        k %= self.n_distinct
        return list(range(k * self.B, (k + 1) * self.B))

    def window(self, seconds):
        def batches():
            self.t0 = time.perf_counter_ns()
            close = self.t0 + int(seconds * 1e9)
            k = 0
            while k == 0 or time.perf_counter_ns() < close:
                yield self._batch(k)
                k += 1

        done = self.stream(batches())
        self.t1 = max(t for t, _ in done)
        self.served = [(row, out) for k, (_, res) in enumerate(done)
                       if res is not None
                       for row, out in zip(self._batch(k), res)]
        self.attempted = len(done) * self.B
        self.failed = sum(res is None for _, res in done) * self.B
        self.panos = self.attempted
        return {"serve_panos_per_s":
                self.attempted / ((self.t1 - self.t0) / 1e9)}
