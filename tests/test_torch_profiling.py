"""The port's trace hooks: spans (utils/profiling.py) in a profiler
session's trace, the inference CLI's ``--profile_dir`` on the CPU device
and the trace_serving report.

On the CPU the profiler asks for CPU activity only (a CPU-only torch asked
for CUDA activity stalls), so the traces hold spans and host ops, no
kernels. The JAX CLI writes a TensorBoard trace directory; the port writes
one Chrome trace, ``*.pt.trace.json``, with the JAX CLI's span names. A
profiled run writes the same JSONs as an unprofiled one, to the byte.
"""

import glob
import importlib.util
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from horizonnet_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")


def _load_trace_serving():
    """The port's tools/trace_serving.py, a script outside the package,
    under a name of its own (the JAX package's tool has the same name)."""
    path = os.path.join(REPO, "horizonnet_tpu_torch", "tools",
                        "trace_serving.py")
    spec = importlib.util.spec_from_file_location("torch_trace_serving",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_serving = _load_trace_serving()


def _spans(trace_dir):
    """{span name: set of thread ids} of the one trace in ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(paths) == 1, paths
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if str(e.get("name", "")).startswith("serve/"):
            out.setdefault(e["name"], set()).add(e.get("tid"))
    return out


def test_spans_of_worker_threads_are_recorded(tmp_path):
    """A span opened on a thread the profiler did not start on is in the
    trace too (serve_stream runs the general tail on worker threads)."""
    def tail(i):
        with profiling.span("serve/general_finish"):
            return i

    t0 = time.perf_counter_ns()
    with profiling.trace_profile("cpu", str(tmp_path)):
        with profiling.span("serve/ingest"):
            pass
        with ThreadPoolExecutor(2) as pool:
            assert list(pool.map(tail, range(3))) == [0, 1, 2]
    spans = _spans(str(tmp_path))
    assert set(spans) == {"serve/ingest", "serve/general_finish"}
    assert not spans["serve/ingest"] & spans["serve/general_finish"]
    # and the recorder kept them, the session being open
    names = [s.name for s in profiling.spans(t0)]
    assert sorted(names) == ["serve/general_finish"] * 3 + ["serve/ingest"]


@pytest.mark.parametrize("extra,want", [
    (["--force_cuboid"], {"serve/ingest", "serve/forward+postproc"}),
    (["--device_postproc"], {"serve/ingest", "serve/general_finish"}),
])
def test_cli_profile_dir_on_cpu(tmp_path, extra, want):
    from horizonnet_tpu_torch.cli.inference import main

    base = ["--pth", CKPT, "--img_glob", os.path.join(FIXDIR,
                                                      "val_room.png"),
            "--device", "cpu", *extra]
    assert main(base + ["--output_dir", str(tmp_path / "plain")]) == 0
    assert main(base + ["--output_dir", str(tmp_path / "prof"),
                        "--profile_dir", str(tmp_path / "trace")]) == 0
    assert set(_spans(str(tmp_path / "trace"))) == want
    assert (tmp_path / "prof" / "val_room.json").read_bytes() == \
        (tmp_path / "plain" / "val_room.json").read_bytes()


def test_trace_serving_report(capsys):
    """Busy time is the union of the device intervals; the span runs from
    the first start to the last end; times are per batch."""
    events = [("k1", 0.0, 10.0), ("conv", 5.0, 20.0), ("k1", 30.0, 40.0),
              ("copy", 35.0, 36.0)]
    got = trace_serving.report(events, 2, top_n=2)
    assert got["busy_ms"] == pytest.approx(30.0 / 1e3 / 2)
    assert got["span_ms"] == pytest.approx(40.0 / 1e3 / 2)
    assert got["busy_share"] == pytest.approx(0.75)
    assert got["kernels"] == pytest.approx({"k1": 0.01, "conv": 0.0075,
                                            "copy": 0.0005})
    table = capsys.readouterr().out
    assert "k1" in table and "copy" not in table
    assert trace_serving.report([], 1)["busy_share"] == 0.0


@pytest.mark.parametrize("fmt", ["uint8", "dct4"])
def test_trace_serving_batch_is_val_room_rolled(fmt):
    import numpy as np
    from horizonnet_tpu_torch.utils.image import read_png

    x = trace_serving.demo_batch(3, "uint8", seed=4)
    img = read_png(os.path.join(FIXDIR, "val_room.png"))[..., :3]
    rolls = np.random.default_rng(4).integers(0, 1024, 3)
    for b, r in enumerate(rolls):
        np.testing.assert_array_equal(x[b], np.roll(img, r, axis=1))
    if fmt == "dct4":
        from horizonnet_tpu_torch.ops.dct import pack_dct4
        np.testing.assert_array_equal(trace_serving.demo_batch(3, fmt,
                                                               seed=4),
                                      pack_dct4(x))
