"""The serving cells: the program's captured engine under ``serve_stream``.

Set-up makes the seeded weights on the card (weights.py), loads them into
the program's model (bf16, the bi-LSTM on K1) and its ``InferenceEngine``
at the cell's batch, wire and fit, which captures its program, then warms
the whole path with the cell's own requests. The window drives
``serve_stream`` (depth and tail workers from the traffic file) with the
program's own host tail as ``finish`` on the worker thread, timing each
``put``, ``run`` and ``finish`` as a span: a proxy engine times the first
two, the finish wrapper the third and the moment each result was on the
host. Every result is kept for the judge.

The requests are val_room.npz rolled by whole columns (a horizontal roll
keeps a pano a valid pano), drawn from the seed and packed to the dct4
wire by the benchmark's own packer before set-up ends.
"""

import os
import time

import numpy as np
import torch

from harness import judge_serve
from harness.cell import BENCH_DIR
from harness.weights import seeded_weights
from reference import dct4 as ref_dct


def load_pano():
    with np.load(os.path.join(BENCH_DIR, "data", "val_room.npz")) as f:
        return f["pano"]


def rolled(pano, rolls):
    return np.stack([np.roll(pano, int(r), axis=1) for r in rolls])


class TimedEngine:
    """The engine under ``serve_stream``, with its ``put`` and ``run``
    timed as spans; ``index[id(outs)]`` numbers each run's outputs in the
    order the runs were queued."""

    def __init__(self, engine, spans):
        self.engine, self.spans = engine, spans
        self.index = {}
        self.runs = 0

    def put(self, x):
        with self.spans("put"):
            return self.engine.put(x)

    def run(self, x):
        with self.spans("run"):
            outs = self.engine.run(x)
        self.index[id(outs)] = self.runs
        self.runs += 1
        return outs


class Serving:
    """One serving cell at one seed: ``rows`` are the distinct input panos
    (dct4 wire rows); each request is a list of row indices."""

    def __init__(self, cell, seed, device, spans):
        self.cell, self.seed, self.device = cell, seed, device
        self.spans = spans
        c, t = cell.config, cell.traffic
        self.H, self.W = c["input_height"], c["input_width"]
        wire = c["wire"]
        self.dct = (wire["luma_m"], wire["chroma_m"], wire["quality"])
        if c["layout"] != "general":
            raise ValueError("the serving cells serve the general layout")
        self.B = t["batch"]
        self.depth, self.workers = t["depth"], t["tail_workers"]
        self.rng = np.random.default_rng(seed)

    def make_rows(self, n):
        """``n`` distinct panos rolled from the seed, packed."""
        pano = load_pano()
        if pano.shape[:2] != (self.H, self.W):
            raise ValueError(f"pano {pano.shape} is not {self.H}x{self.W}")
        rolls = self.rng.integers(0, self.W, n)
        self.rows = ref_dct.pack_dct4(rolled(pano, rolls), *self.dct)

    def build(self):
        from horizonnet_tpu_torch.inference import InferenceEngine
        from horizonnet_tpu_torch.models import build_model

        c = self.cell.config
        self.state_dict = seeded_weights(c, self.seed, self.device)
        model = build_model(c["backbone"], True, device=self.device,
                            dtype=torch.bfloat16, lstm_impl="kernel")
        self.engine = InferenceEngine(
            model, self.state_dict, batch_size=self.B, H=self.H, W=self.W,
            postproc="general", input_format="dct4",
            dct_luma_m=self.dct[0], dct_chroma_m=self.dct[1],
            dct_quality=self.dct[2], device=self.device)

    def tail(self):
        """The program's host tail: outs -> per pano, what the judge reads
        (the packed candidates as fetched, and the tail's (cor_id, z0,
        z1))."""
        from horizonnet_tpu_torch.postproc import finish_general_batch

        H, W = self.H, self.W

        def finish(outs):
            packed = outs.cpu().numpy()
            return list(zip(packed, finish_general_batch(packed, W, H)))
        return finish

    def stream(self, requests):
        """Serve ``requests`` (row-index lists, consumed lazily) through
        serve_stream -> per request (end ns, outputs or None if it
        failed), in order."""
        from horizonnet_tpu_torch.inference import serve_stream

        tail = self.tail()
        timed = TimedEngine(self.engine, self.spans)
        done = {}

        def finish(outs):
            i = timed.index.pop(id(outs))
            with self.spans("finish"):
                try:
                    res = tail(outs)
                except Exception as e:  # noqa: BLE001 - a failed request
                    res = None
                    self.errors.append(repr(e))
            done[i] = (time.perf_counter_ns(), res)

        self.errors = []
        feed = (self.rows[rows] for rows in requests)
        for _ in serve_stream(timed, feed, depth=self.depth, finish=finish,
                              workers=self.workers):
            pass
        return [done[i] for i in range(len(done))]

    def release(self):
        """Free the program's state before the judge runs on the card."""
        self.engine = None
        torch.cuda.empty_cache()

    def judge(self):
        """{number: widest gap} of every pano the window served
        (``self.served``: [(row, output)]) against the reference."""
        rows = judge_serve.distinct(self.served, judge_serve.same_output)
        bon, cor = judge_serve.reference_outputs(
            self.rows, self.state_dict, self.H, self.W, self.dct,
            self.device)
        return judge_serve.compare(rows, bon, cor, self.H, self.W)
