"""The LGT-Net training cell (kinds/lgt_train.py) at a small size on the
CPU: a whole run through ``run_cell`` with the look for a card skipped,
the judge's verdict on the sound program, on the float8 control and on
each planted fault of reference/lgt.py, and the yardstick's counts."""

import time

import pytest
import torch

from harness import runner
from harness.cell import load_cell

NAME = "lgt-mp3d-train-b24"
W = 256


def small(cell):
    """The cell at 512x256 (64 columns, four windows), batch 2 from 4
    rooms."""
    cell.config["input_width"] = W
    cell.config["patch_num"] = W // 4
    cell.config["rpe"]["global"] = W // 8 + 1
    cell.traffic["rooms"] = 4
    cell.config["train"]["batch_size"] = 2
    return cell


@pytest.fixture(autouse=True)
def float32_training(monkeypatch):
    """The program in float32: at this size a bf16 step departs from the
    float32 reference further than the limits, set at the cell's own size
    on the card, allow."""
    import horizonnet_tpu_torch.models as models

    build = models.build_model

    def model(*a, **k):
        if k.get("param_dtype") is torch.float32:
            k = dict(k, dtype=torch.float32)
        return build(*a, **k)
    monkeypatch.setattr(models, "build_model", model)


def run(trace=False, seed=5):
    return runner.run_cell(small(load_cell(NAME)), seed, 0.5, trace,
                           torch.device("cpu"), time.perf_counter_ns(),
                           require_card=False)


def test_a_run_of_the_cell():
    out = run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"train_panos_per_s", "setup_s"}
    assert list(out["checks"]) == ["grad_gap", "update_gap", "turn_gap",
                                   "rpe_turn"]


def test_a_traced_run_reads_what_the_cpu_has():
    """On the CPU no profiler session turns the program's tracing on and
    the eager program records no device stages, so the span, stage and
    roofline metrics are left out (their readers return None and do not
    raise); the MFU and the idle share are read."""
    out = run(trace=True)
    got = set(out["metrics"])
    assert {"lgt_train_mfu_pct", "device_idle_pct.lgt_train"} <= got
    assert not got & {"swg_fwd_device_ms.lgt_train", "label_ms.lgt_train",
                      "swg_roofline.lgt_train"}
    assert out["metrics"]["lgt_train_mfu_pct"]["value"] > 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        monkeypatch):
    from horizonnet_tpu_torch.train import step

    monkeypatch.setattr(step.Optimizer, "step", lambda self: None)
    out = run()
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("path", ["fp8", "no_rg", "unshifted",
                                  "rw_transposed"])
def test_the_control_and_each_planted_fault_are_not_correct(path):
    from harness.judge_lgt_train import readings

    cell = small(load_cell(NAME))
    gaps = readings(cell, 3, path, torch.device("cpu"))
    limits = cell.config["limits"][cell.kind]
    assert any(gaps[k] > v for k, v in limits.items()), gaps


@pytest.mark.parametrize("key, value", [
    ("heads", 16), ("win_size", 8), ("patch_num", 256),
    ("blocks", ["global", "window", "shifted", "global"] * 2),
    ("loss", {"depth": 1.0, "ratio": 0.1, "normal": 0.1, "grad": 0.1})])
def test_a_configuration_other_than_the_built_one_is_refused(key, value):
    from harness.kinds.lgt_train import Driver
    from harness.trace import Spans

    cell = small(load_cell(NAME))
    cell.config[key] = value
    with pytest.raises(SystemExit, match=key):
        Driver(cell, 5, torch.device("cpu"), Spans()).setup()


def test_swg_operations_are_the_blocks_products():
    """Forward: a block's products 2 N C (3C + C + 2 * 2C), a global
    block's attention 2 * 2 N^2 C, a window block's 2 * 2 N 16 C; the
    backward twice the forward."""
    from harness.lgt_flops import swg_bytes, swg_ops

    n, c = 256, 1024
    fwd = 8 * 2 * n * c * 8 * c + 4 * 4 * n * n * c + 4 * 4 * n * 16 * c
    assert swg_ops(1, 1024) == 3 * fwd
    assert swg_ops(24, 1024) == 24 * 3 * fwd
    params = 8 * (4 * c * c + c + 4 * c * c + 3 * c + 4 * c) \
        + 4 * 8 * 129 + 4 * 8 * 31
    assert swg_bytes(24, 1024) == 8 * params + 16 * 24 * n * c * 8


def test_train_flops_count_the_encoder_and_the_transformer():
    from harness import flops, lgt_flops

    lgt = lgt_flops.train_flops_per_pano(512, 1024)
    hn = flops.train_flops_per_pano(512, 1024)
    # the same encoder; the transformer in the bi-LSTM's place
    assert lgt - lgt_flops.swg_ops(1, 1024) == pytest.approx(
        hn - 3 * 2 * 256 * 2 * (4 * 512 * 1024 + 4 * 512 * 512 + 4 * 512
                                * 1024 + 4 * 512 * 512), rel=0.01)
