"""Whole runs of each traffic kind at a small size on the CPU, with the
harness's look for a card skipped: the result line's keys, the judge's
verdict on sound runs, on the control and on the program broken
underneath, and a cell, configuration, traffic mix and per-layer metric
added as files alone."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from harness import runner
from harness.cell import BENCH_DIR, load_cell

W = 256
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small(cell):
    """The cell at 512x256, batch 2, one distinct batch, few requests."""
    cell.config["input_width"] = W
    t = cell.traffic
    if "batch" in t:
        t["batch"] = min(t["batch"], 2)
    if "distinct_batches" in t:
        t["distinct_batches"] = 1
    if "distinct_panos" in t:
        t["distinct_panos"] = 3
        t["rate_per_s"] = 4.0
    if "rooms" in t:
        t["rooms"] = 4
        cell.config["train"]["batch_size"] = 2
    return cell


@pytest.fixture(autouse=True)
def narrow_pano(monkeypatch):
    from harness import serving

    pano = serving.load_pano()[:, ::4].copy()
    monkeypatch.setattr(serving, "load_pano", lambda: pano)


@pytest.fixture(autouse=True)
def float32_training(monkeypatch):
    """The train cell's program in float32: at 512x256 and batch 2 a bf16
    train step departs from the float32 reference further than the
    cell's limits allow, which are set at its own size on the card."""
    import horizonnet_tpu_torch.models as models

    build = models.build_model

    def model(*a, **k):
        if k.get("param_dtype") is torch.float32:
            k = dict(k, dtype=torch.float32)
        return build(*a, **k)
    monkeypatch.setattr(models, "build_model", model)


def run(name, seed=5, trace=False, seconds=0.5, cell=None, **kw):
    cell = cell or small(load_cell(name))
    return runner.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter_ns(), require_card=False, **kw)


@pytest.mark.parametrize("name", ["st3d-serve-b64", "st3d-latency-b1",
                                  "st3d-train-b24"])
def test_a_run_of_each_cell(name, capsys):
    out = run(name)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    cell = load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == e2e
    assert all(v["value"] > 0 for v in out["metrics"].values())
    runner.print_result(out)
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert captured.err.strip().splitlines()[-1].startswith("correct:")


def test_a_traced_run_reads_the_per_layer_metrics():
    out = run("st3d-serve-b64", trace=True)
    assert set(out) == set(KEYS) | {"breakdown", "checks"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    # no device on the CPU: only the metrics read from the host's spans
    assert {"host_tail_ms.serve", "host_dispatch_ms.serve",
            "serve_mfu_pct"} <= set(out["metrics"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(runner.RunFailed):
        runner.run_cell(load_cell("st3d-serve-b64"), 1, 1.0, False,
                        torch.device("cuda", 0), 0)


# the program broken underneath: the judge must say not correct

def _alter_device_answer(monkeypatch):
    """The first pano's first segment mean moved by 5 plan units in every
    batch the engine returns (the packed [B, 9K + 17] general layout)."""
    from horizonnet_tpu_torch import inference

    run_ = inference.InferenceEngine.run

    def altered(self, x):
        out = run_(self, x).clone()
        K = (out.shape[1] - 17) // 9
        out[0, 7 * K] += 5.0
        return out
    monkeypatch.setattr(inference.InferenceEngine, "run", altered)


def _alter_tail_answer(monkeypatch):
    """The first pano's first corner moved by a pixel in every batch the
    host tail finishes."""
    from horizonnet_tpu_torch import postproc

    finish_ = postproc.finish_general_batch

    def altered(*a, **k):
        res = finish_(*a, **k)
        cor_id, z0, z1 = res[0]
        res[0] = (cor_id + np.float32(1.0 / 1024), z0, z1)
        return res
    monkeypatch.setattr(postproc, "finish_general_batch", altered)


def _break_forward(monkeypatch, fault):
    """The program's forward output broken before its fit (the floor row
    set to nought, or the corner row turned), as control.py plants it."""
    import control
    from horizonnet_tpu_torch import inference

    monkeypatch.setattr(inference, "tta_forward", control.broken_forward(
        inference.tta_forward, fault))


def _zero_floor_row(monkeypatch):
    _break_forward(monkeypatch, "floor")


def _turn_corner_row(monkeypatch):
    _break_forward(monkeypatch, "corner")


@pytest.mark.parametrize("name", ["st3d-serve-b64", "st3d-latency-b1"])
@pytest.mark.parametrize("alter", [_alter_device_answer, _alter_tail_answer,
                                   _zero_floor_row, _turn_corner_row],
                         ids=["device", "tail", "floor", "corner"])
def test_an_altered_answer_is_not_correct(monkeypatch, name, alter):
    alter(monkeypatch)
    out = run(name)
    assert not out["correct"]
    # each fault of the forward is caught by its own channel's number
    own = {_zero_floor_row: "floor_gap", _turn_corner_row: "peak_gap"}
    if alter in own:
        c = out["checks"][own[alter]]
        assert c["value"] > c["limit"]


def test_arrivals_are_poisson_from_the_seed():
    from harness.kinds.open_loop_serve import arrival_gaps

    a = arrival_gaps(96.0, 20000, np.random.default_rng(7))
    b = arrival_gaps(96.0, 20000, np.random.default_rng(7))
    c = arrival_gaps(96.0, 20000, np.random.default_rng(8))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(np.sort(a), np.sort(c))
    assert abs(a.mean() * 96.0 - 1.0) < 0.03
    # independent gaps: as many requests in a tenth of a second as a
    # Poisson count has, variance equal to the mean
    counts = np.bincount((np.cumsum(a) / 0.1).astype(np.int64))[:-1]
    assert abs(counts.var() / counts.mean() - 1.0) < 0.1


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        monkeypatch):
    from horizonnet_tpu_torch.train import step

    monkeypatch.setattr(step.Optimizer, "step", lambda self: None)
    out = run("st3d-train-b24")
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_a_step_taken_the_wrong_way_is_not_correct(monkeypatch):
    from horizonnet_tpu_torch.train import step

    lr_at = step.OptimizerSpec.lr_at
    monkeypatch.setattr(step.OptimizerSpec, "lr_at",
                        lambda self, count: -lr_at(self, count))
    out = run("st3d-train-b24")
    assert not out["correct"]
    assert out["checks"]["turn_gap"]["value"] > 1.5


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from horizonnet_tpu_torch.train import engine

    step_ = engine.train_step

    def half(state, x, y_bon, y_cor, *a, **k):
        n = x.shape[0] // 2
        return step_(state, x[:n], y_bon[:n], y_cor[:n], *a, **k)
    monkeypatch.setattr(engine, "train_step", half)
    assert not run("st3d-train-b24")["correct"]


# the control: the reference in float8 in the program's place

@pytest.mark.parametrize("name", ["st3d-serve-b64", "st3d-latency-b1"])
def test_the_fp8_control_is_not_correct(name):
    import control

    cell = small(load_cell(name))
    gaps = control.readings(cell, 3, "fp8", torch.device("cpu"))
    limits = cell.config["limits"][cell.kind]
    assert any(gaps[k] > v for k, v in limits.items())


# adding a cell, a configuration, a traffic mix and a metric as files

@pytest.mark.parametrize("key,value", [("dtype", "float32"),
                                       ("rnn_hidden", 256),
                                       ("train.param_dtype", "bfloat16")])
def test_a_configuration_the_harness_does_not_build_is_refused(key, value):
    from harness.cell import check_config

    c = load_cell("st3d-serve-b64").config
    check_config(c)
    outer, _, inner = key.rpartition(".")
    (c[outer] if outer else c)[inner] = value
    with pytest.raises(SystemExit, match=key):
        check_config(c)


def test_a_cell_added_as_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", "data"))
    with open(os.path.join(BENCH_DIR, "..", "BENCHMARK.json")) as f:
        spec = json.load(f)
    c = json.loads((bench / "configs" / "hn-r50-st3d.json").read_text())
    c["name"] = "hn-r50-copy"
    (bench / "configs" / "hn-r50-copy.json").write_text(json.dumps(c))
    (bench / "traffic" / "batch2-new.json").write_text(json.dumps(
        {"kind": "batch_serve", "batch": 2, "depth": 2, "tail_workers": 1,
         "distinct_batches": 1}))
    (bench / "metrics" / "served_count.new.py").write_text(
        "def read(run):\n    return float(run.driver.panos)\n")
    spec["configs"].append({"name": "hn-r50-copy", "source": "x",
                            "file": "benchmark/configs/hn-r50-copy.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new-cell", "config": "hn-r50-copy",
                              "traffic": "batch2-new", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("new-cell")
    spec["per_layer"].append({"name": "served_count.new", "unit": "panos",
                              "better": "higher", "source": "program_span",
                              "layer": "x", "moves": "serve_panos_per_s",
                              "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("new-cell", spec_path=str(tmp_path / "BENCHMARK.json"),
                     bench_dir=str(bench))
    assert cell.config["name"] == "hn-r50-copy"
    assert [m["name"] for m in cell.per_layer] == ["served_count.new"]
    cell.config["input_width"] = W
    out = run(None, cell=cell, trace=True, bench_dir=str(bench))
    assert out["metrics"]["served_count.new"]["value"] >= 2
    assert out["checks"] and all(np.isfinite(c["value"])
                                 for c in out["checks"].values())
