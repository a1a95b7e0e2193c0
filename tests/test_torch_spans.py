"""The port's span recorder and host counters (utils/profiling.py,
ops/launch_counts.py), on the CPU.

Spans are recorded only while tracing is on, with their parents and
request ids; a profiler session turns tracing on for every thread,
serve_stream's workers too; serve_stream numbers its batches, and a
batch's spans on the main thread and on its worker share the number; a
replay adds kernel launches again, never host counters; the preprocess
CLI's ``--profile`` prints its report from the spans.
"""

import contextlib
import re
import threading
import time

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts with tracing off, and leaves it so."""
    with profiling.enable(False):
        yield


def _named(t0, prefix):
    return [s for s in profiling.spans(t0) if s.name.startswith(prefix)]


def test_spans_only_while_on_with_parents_and_request_ids():
    t0 = time.perf_counter_ns()
    with profiling.span("t.off"):
        pass
    with profiling.enable():
        with profiling.span("t.outer", req=7):
            with profiling.span("t.inner"):
                pass
            with profiling.span("t.own", req=8):
                pass
        with profiling.request(3):
            with profiling.span("t.in_request"):
                pass
        with profiling.span("t.no_request"):
            pass
    with profiling.span("t.off"):
        pass
    with profiling.span("t.always", note="n", always=True):
        pass
    got = {s.name: s for s in _named(t0, "t.")}
    assert set(got) == {"t.outer", "t.inner", "t.own", "t.in_request",
                        "t.no_request", "t.always"}
    assert (got["t.inner"].parent, got["t.inner"].req) == ("t.outer", 7)
    assert (got["t.own"].parent, got["t.own"].req) == ("t.outer", 8)
    assert (got["t.in_request"].parent, got["t.in_request"].req) == (None, 3)
    assert got["t.no_request"].req is None and got["t.outer"].parent is None
    assert got["t.always"].note == "n"
    assert got["t.outer"].start <= got["t.inner"].start \
        <= got["t.inner"].end <= got["t.outer"].end
    assert all(s.thread == threading.get_ident() for s in got.values())
    lines = profiling.report(t0).splitlines()
    assert len(lines) == 6
    assert re.fullmatch(r"t\.outer: \d+\.\d{3}s total, \d+\.\d ms/call "
                        r"\(1 calls\)", lines[0])
    profiling.clear()
    assert profiling.spans() == []


def _engine():
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.models import build_model

    model = build_model("resnet18", True, device="cpu", seed=3)
    return InferenceEngine(model, model.state_dict(), W=32,
                           input_format="uint8", device="cpu")


class _SpannedEngine:
    """The engine with a span around ``put`` and ``run``, as a caller's
    layer above it would open."""

    def __init__(self, engine):
        self.engine = engine

    def put(self, x):
        with profiling.span("t.put"):
            return self.engine.put(x)

    def run(self, x):
        with profiling.span("t.run"):
            return self.engine.run(x)


def _finish(outs):
    with profiling.span("t.finish"):
        return float(outs[0].sum())


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 256, (1, 512, 32, 3), dtype=np.uint8)
            for _ in range(4)]


def test_serve_stream_shares_each_batch_number(batches):
    """A batch's spans on the main thread (its put and run, its wait for
    the result) and on the worker (its finish) carry the batch's number."""
    eng = _SpannedEngine(_engine())
    t0 = time.perf_counter_ns()
    with profiling.enable():
        got = list(_stream(eng, batches))
    assert len(got) == 4
    spans = _named(t0, "t.") + _named(t0, "serve.")
    main = threading.get_ident()
    by = {}
    for s in spans:
        by.setdefault(s.req, []).append((s.name, s.thread == main))
    assert sorted(by) == [0, 1, 2, 3]
    for req, names in by.items():
        assert sorted(names) == [("serve.wait_result", True),
                                 ("t.finish", False), ("t.put", True),
                                 ("t.run", True)], req


def _stream(eng, batches):
    from horizonnet_tpu_torch.inference import serve_stream

    return serve_stream(eng, iter(batches), depth=2, finish=_finish,
                        workers=1)


def test_a_profiler_session_turns_tracing_on_for_workers(batches):
    """Inside a torch.profiler session, without enable(), serve_stream's
    worker records its spans: the flag read is the process-wide one."""
    from torch.profiler import ProfilerActivity, profile

    eng = _engine()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert list(_stream(eng, batches[:2])) is not None
    with profiling.span("t.after"):
        pass
    spans = _named(t0, "t.")
    assert [s.req for s in spans] == [0, 1]
    assert {s.name for s in spans} == {"t.finish"}
    assert all(s.thread != threading.get_ident() for s in spans)


def test_a_replay_adds_kernel_launches_never_host_counters(monkeypatch):
    """The replay's bookkeeping adds the captured kernel launches and
    counts the replay once; a capture reads kernel launch counts only, so
    a host counter never enters what a replay adds."""
    from horizonnet_tpu_torch import program
    from horizonnet_tpu_torch.ops import cuda_lstm, launch_counts

    class Graph:
        def replay(self):
            pass

    prog = program.CapturedProgram.__new__(program.CapturedProgram)
    prog.device, prog.graph, prog.outputs = torch.device("cpu"), Graph(), ()
    prog.stages = []
    prog.launches = {(cuda_lstm.__name__, "launches"): 2}
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    assert not set(launch_counts.read()) & set(launch_counts.HOST)
    assert {(program.__name__, "replays"),
            (program.__name__, "captures")} <= set(launch_counts.HOST)
    before = launch_counts.named()
    t0 = time.perf_counter_ns()
    prog.replay()
    with profiling.enable(), profiling.request(5):
        prog.replay()
    after = launch_counts.named()
    assert after["cuda_lstm.launches"] - before["cuda_lstm.launches"] == 4
    assert after["program.replays"] - before["program.replays"] == 2
    assert after["program.captures"] == before["program.captures"]
    assert [(s.name, s.req) for s in _named(t0, "program.")] == [
        ("program.replay", 5)]


def test_preprocess_profile_prints_the_spans_report(tmp_path, capsys,
                                                    monkeypatch):
    """--profile turns tracing on for the run and prints each stage's
    total from the spans, in the report's format; without it nothing is
    recorded or printed."""
    from horizonnet_tpu_torch.cli import preprocess

    for name in ("a", "b"):
        (tmp_path / f"{name}.png").write_bytes(b"")

    def one(path, args, backend, device, lsd_workers=None):
        with profiling.span("preprocess/decode"):
            pass
        with profiling.span("preprocess/lsd"):
            pass
    monkeypatch.setattr(preprocess, "_process_one", one)
    flags = ["--img_glob", str(tmp_path / "*.png"), "--output_dir",
             str(tmp_path / "out"), "--device", "cpu", "--num_workers", "1"]
    t0 = time.perf_counter_ns()
    def report():   # stderr's lines but the progress bar's
        return [line for line in capsys.readouterr().err.splitlines()
                if line.startswith("preprocess/")]

    assert preprocess.main(flags) == 0
    assert report() == [] and not _named(t0, "preprocess/")
    assert preprocess.main(flags + ["--profile"]) == 0
    lines = report()
    assert sorted(line.split(":")[0] for line in lines) == [
        "preprocess/decode", "preprocess/lsd"]
    assert all(line.endswith("ms/call (2 calls)") for line in lines)
    assert not profiling._enabled
