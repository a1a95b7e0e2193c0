"""The port's training-throughput tool
(horizonnet_tpu_torch/tools/train_throughput.py) and the train step's FLOP
count, on the CPU: every mode at a tiny size (no timing bar), the JSON
line's figures, and the count against the forward's."""

import importlib.util
import json
import os

import numpy as np
import torch

from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.utils.flops import serving_flops, train_step_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "horizonnet_tpu_torch", "tools",
                    "train_throughput.py")
MODES = ("device", "multi_8", "host_f32", "host_uint8", "host_dct",
         "host_dct4")


def _tool():
    spec = importlib.util.spec_from_file_location("train_throughput", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_mode_runs_on_the_cpu():
    """pallas_train: K2/K3's plain twins on CPU tensors."""
    lstm_impl = "pallas_train"
    lines = []
    rec = _tool().measure(1, 1, "resnet18", "f32", lstm_impl, "cpu",
                          W=128, n_host=1, n_multi=1, emit=lines.append)
    assert json.loads(lines[-1]) == json.loads(json.dumps(rec))
    text = "\n".join(lines[:-1])
    for label in ("device-resident:", "8-step replays:", "host-fed f32:",
                  "host-fed uint8:", "host-fed dct:", "host-fed dct4:"):
        assert label in text, label
    assert set(rec["ms_per_step"]) == set(MODES)
    for k in MODES:
        assert np.isfinite(rec["ms_per_step"][k]) and rec["ms_per_step"][k] > 0
        assert np.isfinite(rec["panos_per_sec"][k])
    assert all(np.isfinite(v) for v in rec["losses"].values())
    assert rec["step_gflops"] > 0 and np.isfinite(rec["step_gflops"])
    assert rec["device"] == "cpu" and rec["train_mfu_pct"] is None
    assert rec["config"] == {"steps": 1, "batch": 1, "backbone": "resnet18",
                             "dtype": "f32", "lstm_impl": lstm_impl,
                             "H": 512, "W": 128}


def test_arguments_and_defaults_are_jax():
    import inspect

    sig = inspect.signature(_tool().measure)
    got = [sig.parameters[k].default for k in
           ("steps", "bs", "backbone", "dtype", "lstm_impl", "device")]
    assert got == [30, 24, "resnet50", "bf16", "scan", "cuda"]


def test_train_step_flops_against_the_forward():
    """Forward + backward of the products is 3x the forward, less the first
    convolution's input gradient: between 2.5x and 3.0x; the same count
    whatever the LSTM implementation (the count runs the plain twin)."""
    H, W = 512, 128
    m = build_model("resnet18", True, device="cpu", dtype=torch.bfloat16)
    fwd = serving_flops(m, 1, H, W)
    step = train_step_flops(m, 1, H, W)
    assert 2.5 * fwd < step < 3.0 * fwd
    assert train_step_flops(m, 3, H, W) == 3 * step
    kern = build_model("resnet18", True, device="cpu", dtype=torch.bfloat16,
                       lstm_impl="kernel_train")
    assert train_step_flops(kern, 1, H, W) == step
