"""The per-layer metrics read from the program's own spans and counters
(harness/program_spans.py): each reads a number on a traced CPU run of
its cell with the program's tracing on (the serving program's device
stages aside, which only a captured program on the card records), and
nothing where the program records no spans."""

import json
import os
import types

import pytest

from harness import runner
from harness.cell import ROOT, load_cell
from test_bench_cells import (float32_training, narrow_pano,  # noqa: F401
                              run, small)

STAGES = {f"{s}_device_ms.serve" for s in ("decode", "encoder", "head",
                                             "fit")}


def _program_span_metrics(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    added = {m["name"] for m in spec["per_layer"]
             if m["source"] == "program_span"
             and m["name"] not in ("host_tail_ms.serve",
                                   "host_dispatch_ms.serve",
                                   "host_dispatch_ms.latency",
                                   "batch_build_ms.train")}
    return {m["name"] for m in cell.per_layer} & added


@pytest.mark.parametrize("name", ["st3d-serve-b64", "st3d-latency-b1",
                                  "st3d-train-b24"])
def test_each_new_metric_reads_a_number(name):
    from horizonnet_tpu_torch.utils import profiling

    cell = small(load_cell(name))
    want = _program_span_metrics(cell) - STAGES
    assert {"capture_s", "kernel_load_s"} <= want
    with profiling.enable():
        out = run(name, trace=True, cell=cell)
    assert out["correct"]
    got = out["metrics"]
    for m in want:
        assert m in got and isinstance(got[m]["value"], float), m
        assert got[m]["value"] >= 0, m
    assert not STAGES & set(got)
    if name == "st3d-serve-b64":
        assert got["feed_wait_ms.serve"]["value"] > 0
        assert got["tail_fit_ms.serve"]["value"] > 0
    if name == "st3d-train-b24":
        assert got["augment_upload_ms.train"]["value"] > 0
        assert got["label_ms.train"]["value"] > 0


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """Over the parent program, which has no ``spans``, each reader gives
    None and raises nothing."""
    from horizonnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    cell = small(load_cell("st3d-latency-b1"))
    d = types.SimpleNamespace(attempted=4, B=1)
    view = types.SimpleNamespace(cell=cell, driver=d, t0=0, t1=1, ops=[],
                                 launches={})
    for m in _program_span_metrics(cell):
        assert runner.load_metric(m).read(view) is None, m
