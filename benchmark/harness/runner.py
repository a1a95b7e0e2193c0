"""One run of one cell: set-up, the window, the judge, the result line.

``run_cell`` is the whole run that benchmark/run.py makes; tests drive it
on the CPU with ``require_card=False`` and smaller sizes. Order: the
kind's driver sets up (weights, the program, warm-up), the window runs
(under the device trace with ``trace``), the peak memory is read, the
process is checked for JAX, the program's state is freed, the judge runs
the reference, and the metrics are read: the cell's end-to-end metrics
without ``trace``, its per-layer metrics (``metrics/<name>.py``) with it.
"""

import importlib
import importlib.util
import json
import os
import sys
from contextlib import nullcontext

from harness.cell import BENCH_DIR
from harness.trace import (DeviceTrace, Spans, idle_by_span, top_ops,
                           union_seconds)

#: top-level module names the program under test must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "horizonnet_tpu")


class RunFailed(Exception):
    """The run cannot print a result (exit code 2)."""


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_metric(name, bench_dir=BENCH_DIR):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TracedRun:
    """What a per-layer metric reads: the cell, the driver (its sizes and
    counters), the host spans, the device operations inside the traced
    window, its seconds and busy seconds, and each kernel wrapper's
    launches over the window (``launches["cuda_lstm.launches"]``)."""

    def __init__(self, cell, driver, spans, ops, launches):
        self.cell, self.driver, self.spans = cell, driver, spans
        self.t0, self.t1 = driver.t0, driver.t1
        self.window_s = (self.t1 - self.t0) / 1e9
        self.ops = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in ops
                    if b > self.t0 and a < self.t1]
        self.busy_s = union_seconds([(a, b) for _, a, b in self.ops])
        self.launches = launches

    def kernel_seconds(self, match):
        """(launches seen, seconds) of the device operations whose name
        ``match`` accepts."""
        times = [(b - a) / 1e9 for n, a, b in self.ops if match(n)]
        return len(times), sum(times)

    def span_seconds(self, name):
        return self.spans.named(name, self.t0, self.t1)


def _launch_counts():
    from horizonnet_tpu_torch.ops import launch_counts

    return launch_counts.named()


def run_cell(cell, seed, seconds, trace, device, t_start,
             require_card=True, bench_dir=BENCH_DIR):
    """Run ``cell`` once; returns the result line's object. Raises
    RunFailed where no result may be printed."""
    import torch

    if require_card:
        if not torch.cuda.is_available():
            raise RunFailed("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            raise RunFailed(f"{torch.cuda.device_count()} CUDA devices, the "
                            f"cell needs {cell.chips}")
    on_card = device.type == "cuda"
    kind = importlib.import_module("harness.kinds." + cell.kind)
    spans = Spans()
    driver = kind.Driver(cell, seed, device, spans)
    driver.setup()
    if trace:
        seconds = min(seconds, cell.traffic.get("trace_seconds", seconds))
    counts0 = _launch_counts()
    tracer = DeviceTrace() if trace and on_card else nullcontext()
    with tracer:
        e2e = driver.window(seconds)
    counts1 = _launch_counts()
    setup_s = (driver.t0 - t_start) / 1e9
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise RunFailed(f"the process loaded {bad}")
    driver.release()
    gaps = driver.judge()
    limits = cell.config["limits"][cell.kind]
    checks = {k: {"value": gaps[k], "limit": v} for k, v in limits.items()}
    correct = driver.failed == 0 and all(gaps[k] <= v
                                         for k, v in limits.items())

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        ops = getattr(tracer, "ops", [])
        launches = {k: counts1[k] - counts0.get(k, 0) for k in counts1}
        view = TracedRun(cell, driver, spans, ops, launches)
        print(f"kernel launches over the window: "
              f"{json.dumps({k: v for k, v in launches.items() if v})}; "
              f"device operations traced: {len(view.ops)}", file=sys.stderr)
        for m in cell.per_layer:
            v = load_metric(m["name"], bench_dir).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        breakdown = {"device_ops": top_ops(view.ops),
                     "idle_gaps": idle_by_span(view.ops, spans, view.t0,
                                               view.t1)}
    out = {"correct": bool(correct), "attempted": int(driver.attempted),
           "failed": int(driver.failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def print_result(out):
    """The checks as the last lines on standard error, then the result as
    the last line of standard output."""
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def main(argv, t_start):
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from harness.cell import load_cell

    cell = load_cell(a.workload)
    try:
        import torch

        out = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                       torch.device("cuda", 0), t_start)
    except RunFailed as e:
        print(f"run failed: {e}", file=sys.stderr, flush=True)
        return 2
    print_result(out)
    return 0
