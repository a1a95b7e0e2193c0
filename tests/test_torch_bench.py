"""The port's bench (horizonnet_tpu_torch/bench.py) against the JAX
package's bench.py contract, and its FLOP count against XLA's.

The contract is tests/test_bench_contract.py's, held on the port: the
demo batches, the wire packers (byte for byte the JAX package's), the
knobs, the median-after-a-discarded-warm-up headline, every key of JAX's
JSON line, and finish() single-argument at every call site. Then the
bench runs end to end on the CPU at a tiny size (BENCH_DEVICE=cpu: the
control flow only, no timing bar).
"""

import ast
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from horizonnet_tpu.inference import InferenceEngine as JaxEngine
from horizonnet_tpu.models import build_model as jax_build_model
from horizonnet_tpu.models.registry import init_model
from horizonnet_tpu_torch import bench
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.ops.dct import (DEFAULT_CHROMA_M, DEFAULT_LUMA_M,
                                          DEFAULT_QUALITY)
from horizonnet_tpu_torch.utils.flops import serving_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BENCH = os.path.join(ROOT, "horizonnet_tpu_torch", "bench.py")
JAX_BENCH = os.path.join(ROOT, "bench.py")
WIRE = (DEFAULT_LUMA_M, DEFAULT_CHROMA_M, DEFAULT_QUALITY)
KNOBS = ("BENCH_B", "BENCH_DEPTH", "BENCH_FMT", "BENCH_POSTPROC",
         "BENCH_REPS", "BENCH_E2E", "BENCH_DCT_LUMA_M", "BENCH_DCT_CHROMA_M",
         "BENCH_DCT_Q", "BENCH_LSTM", "BENCH_S2D", "BENCH_QUANT",
         "BENCH_FUSED", "BENCH_E2E_WORKERS", "BENCH_E2E_B", "BENCH_E2E_N",
         "BENCH_DEVICE")


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_line_keys():
    """The keys of the JSON line that JAX's bench.py prints."""
    tree = ast.parse(open(JAX_BENCH).read())
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "dumps" and n.args
                and isinstance(n.args[0], ast.Dict)):
            return {k.value for k in n.args[0].keys}
    raise AssertionError("bench.py prints no JSON line")


@pytest.fixture(scope="module")
def cpu_run():
    """The bench end to end on the CPU: resnet18_rnn f32, batch 1, at
    512x512, every section (serving reps, device rate, e2e on 2 raw
    panos)."""
    lines = []
    cfg = bench.BenchConfig(B=1, depth=1, reps=2, e2e_workers=1, e2e_B=1,
                            e2e_N=2, device="cpu", backbone="resnet18",
                            dtype=torch.float32, W=512, panos_per_rep=1,
                            n_dev=1)
    rec = bench.run(cfg, emit=lines.append)
    return rec, [json.loads(line) for line in lines]


def test_demo_batches_shape_and_dtype():
    batches = bench._demo_batches(2, 64, 128, n_distinct=2)
    assert len(batches) == 2
    for b in batches:
        assert b.shape == (2, 64, 128, 3) and b.dtype == np.uint8
    # rolled copies of one pano: every row holds the same pixel multiset
    assert np.array_equal(np.sort(batches[0][0], axis=None),
                          np.sort(batches[1][1], axis=None))


@pytest.mark.parametrize("fmt", ["float", "uint8", "yuv420", "dct", "dct4"])
def test_pack_is_the_jax_packers_byte_for_byte(fmt):
    batches = bench._demo_batches(2, 64, 128, n_distinct=1)
    got = bench._pack(batches, fmt, *WIRE)[0]
    want = _jax_bench()._pack(batches, fmt, *WIRE)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.asarray(want).tobytes()


def test_every_knob_is_read():
    src = open(PORT_BENCH).read()
    for knob in KNOBS:
        assert knob in src, knob
    env = {"BENCH_B": "7", "BENCH_DEPTH": "2", "BENCH_FMT": "uint8",
           "BENCH_POSTPROC": "general", "BENCH_REPS": "4", "BENCH_E2E": "0",
           "BENCH_DCT_LUMA_M": "10", "BENCH_DCT_CHROMA_M": "3",
           "BENCH_DCT_Q": "75", "BENCH_LSTM": "scan", "BENCH_S2D": "1",
           "BENCH_QUANT": "1", "BENCH_FUSED": "1", "BENCH_E2E_WORKERS": "3",
           "BENCH_E2E_B": "4", "BENCH_E2E_N": "12", "BENCH_DEVICE": "cpu"}
    c = bench.BenchConfig.from_env(env)
    assert (c.B, c.depth, c.fmt, c.postproc, c.reps, c.e2e) == (
        7, 2, "uint8", "general", 4, False)
    assert (c.dct_ym, c.dct_cm, c.dct_q, c.lstm) == (10, 3, 75, "scan")
    assert (c.s2d, c.quant, c.fused) == (True, True, True)
    assert (c.e2e_workers, c.e2e_B, c.e2e_N, c.device) == (3, 4, 12, "cpu")
    # the JAX bench's defaults, on the card
    d = bench.BenchConfig.from_env({})
    assert (d.B, d.depth, d.fmt, d.postproc, d.reps, d.e2e, d.e2e_B) == (
        64, 3, "dct4", "cuboid", 5, True, 8)
    assert (d.lstm, d.device, d.e2e_N, (d.dct_ym, d.dct_cm, d.dct_q)) == (
        "pallas", "cuda", None, WIRE)
    assert (d.backbone, d.dtype, d.H, d.W) == ("resnet50", torch.bfloat16,
                                               512, 1024)


def test_headline_is_the_median_after_a_discarded_warm_up():
    loops = iter([1.0, 40.0, 10.0, 30.0, 20.0])
    rates = iter([5.0, 6.0, 7.0])
    warm, reps, ingest = bench._serving_reps(lambda: next(loops),
                                             lambda: next(rates), 5)
    assert warm == 1.0 and reps == [40.0, 10.0, 30.0, 20.0]
    assert ingest == (6.0, 7.0)       # the first rate only warms the path
    h = bench._headline(warm, reps)
    assert h["value"] == 25.0 and h["best_panos_per_sec"] == 40.0
    assert h["warmup_rep_panos_per_sec"] == 1.0
    assert h["reps_spread_pct"] == 120.0 and h["vs_baseline"] == 1.25
    # one rep: no warm-up loop to discard
    warm, reps, _ = bench._serving_reps(lambda: 3.0, lambda: 1.0, 1)
    assert warm is None and reps == [3.0]


def test_finish_callsites_single_arg():
    tree = ast.parse(open(PORT_BENCH).read())
    calls = [n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
             and n.func.id == "finish"]
    assert calls, "bench no longer calls finish()?"
    for c in calls:
        assert len(c.args) == 1 and not c.keywords, c.lineno
    defs = [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef) and n.name == "finish"]
    assert defs
    for d in defs:
        assert len(d.args.args) == 1, d.lineno


def test_cpu_run_prints_jax_keys_provisional_first(cpu_run):
    rec, lines = cpu_run
    assert len(lines) == 2 and lines[-1] == json.loads(json.dumps(rec))
    first, last = lines
    assert first["provisional"] is True and "provisional" not in last
    assert first["e2e_panos_per_sec"] is None
    missing = _jax_line_keys() - set(last)
    assert not missing, missing
    assert len(json.dumps(last)) < 2048
    for k in ("value", "device_panos_per_sec", "best_panos_per_sec",
              "fwd_gflops_per_pano", "e2e_panos_per_sec", "e2e_vs_baseline",
              "e2e_vs_baseline_gpu_adj", "preprocess_s_per_pano"):
        assert np.isfinite(last[k]) and last[k] > 0, k
    assert all(np.isfinite(last["reps_panos_per_sec"]))
    assert all(np.isfinite(last["ingest_mb_per_s"]))
    assert last["e2e_no_vp"] in (0, 1, 2)
    # no card: no device MFU, and the line says so
    assert last["device"] == "cpu"
    assert last["serving_mfu_pct"] is None and last["peak_flops"] is None
    ref = json.load(open(os.path.join(ROOT, "REF_E2E.json")))
    assert last["ref_e2e_panos_per_sec"] == ref["e2e_panos_per_sec"]
    assert last["config"]["fmt"] == "dct4"


def test_serving_flops_match_xla_with_the_loop_counted():
    """resnet18_rnn, f32, B=1, 512x256: the JAX engine's XLA count plus the
    (T-1) recurrence steps that XLA's count of the scan's body leaves out
    (T = W/4 steps, 2 layers, 2 directions, 2*B*H*4H a step), within 2 %
    of the port's count (1.1 % when this test was written)."""
    H, W, T, hidden = 512, 256, 64, 512
    jmodel = jax_build_model("resnet18", use_rnn=True)
    # the variables' shapes do not depend on the width
    variables = init_model(jmodel, jax.random.PRNGKey(0), (1, H, 32, 3))
    eng = JaxEngine(jmodel, variables, batch_size=1, H=H, W=W,
                    postproc="cuboid")
    ca = eng.compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    xla = float(ca["flops"]) + (T - 1) * 2 * 2 * (2 * 1 * hidden * 4 * hidden)
    port = build_model("resnet18", True, device="cpu")
    got = serving_flops(port, 1, H, W, postproc="cuboid")
    assert abs(got - xla) / xla < 0.02, (got, xla)
    # the TTA copies run as one batch of 3 and are counted
    assert serving_flops(port, 1, H, W, flip=True, rotate=(0.5,)) == 3 * got
