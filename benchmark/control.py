#!/usr/bin/env python3
"""Readings of the controls of a serving cell, for setting its limits.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--path fp8 int8]

For each seed, the cell's inputs and weights are made as a run makes
them, and every distinct input is served by a control in the program's
place; the judge (harness/judge_serve.py) compares what it served with
the float32 reference, as it compares a run's results, and one JSON line
a seed and path gives each number's reading. Paths:

``fp8``   the reference computed with every product's operands in float8
          e4m3 (reference/model.py::fp8): the precision below the
          configuration's bf16. The fit and the tail are the reference's.
``int8``  the program's own int8 serving path (``quant_int8``: the resnet
          encoder's convolutions in int8, the rest in bf16), through its
          engine and host tail.
``bf16``  the program as the cell runs it (its engine and host tail over
          each distinct input once; for the train cell its checked steps):
          the sound readings, a dozen seeds in one process.
``half``  the train cell's fault: the reference, in the program's place,
          with half of each batch left out and the mean taken over the
          rest.
``ascent`` the train cell's fault: the reference, in the program's place,
          with each Adam update taken the wrong way (gradient ascent).
``floor``, ``corner``  the serving cells' faults: the program with the
          floor boundary row of its forward's output set to nought, or
          its corner row turned by a sixteenth of the pano, before the
          fit.

Not part of a benchmark run; it needs the card at the cell's own size.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def fp8_served(driver):
    """[(row, output)] of the fp8 reference over every distinct row."""
    from harness import judge_serve
    from reference.model import fp8

    bon, cor = judge_serve.reference_outputs(
        driver.rows, driver.state_dict, driver.H, driver.W, driver.dct,
        driver.device, lowp=fp8)
    return list(enumerate(judge_serve.served_by_reference(
        bon, cor, driver.H, driver.W)))


def broken_forward(forward, fault):
    """The program's ``forward`` (``inference.tta_forward``) broken before
    its fit: ``floor`` sets the floor boundary row to nought, ``corner``
    turns the corner row by a sixteenth of the pano."""
    import torch

    def broken(*a, **k):
        bon, cor = forward(*a, **k)
        if fault == "floor":
            bon = torch.stack([bon[:, 0], torch.zeros_like(bon[:, 1])], 1)
        else:
            cor = torch.roll(cor, cor.shape[-1] // 16, dims=-1)
        return bon, cor
    return broken


def plant(fault):
    """Break the program's forward as ``broken_forward`` does; returns a
    function that undoes it."""
    from horizonnet_tpu_torch import inference

    forward = inference.tta_forward
    inference.tta_forward = broken_forward(forward, fault)
    return lambda: setattr(inference, "tta_forward", forward)


def program_served(driver, int8):
    """[(row, output)] of the program (with ``int8`` its int8 path) over
    every distinct row, through its engine and its host tail."""
    import torch
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.models.quant import quantize_state_dict

    model = build_model(driver.cell.config["backbone"], True,
                        device=driver.device, dtype=torch.bfloat16,
                        lstm_impl="kernel", quant_int8=int8)
    sd = driver.state_dict
    if int8:
        sd = quantize_state_dict({k: v.clone() for k, v in sd.items()})
    engine = InferenceEngine(
        model, sd, batch_size=driver.B, H=driver.H, W=driver.W,
        postproc="general", input_format="dct4",
        dct_luma_m=driver.dct[0], dct_chroma_m=driver.dct[1],
        dct_quality=driver.dct[2], device=driver.device)
    tail = driver.tail()
    served = []
    for i in range(0, len(driver.rows), driver.B):
        rows = list(range(i, min(i + driver.B, len(driver.rows))))
        rows += [rows[-1]] * (driver.B - len(rows))
        res = tail(engine(driver.rows[rows]))
        served += list(zip(rows, res))
    return served


def serve_readings(cell, seed, path, device):
    import importlib

    from harness import judge_serve
    from harness.trace import Spans
    from harness.weights import seeded_weights

    kind = importlib.import_module("harness.kinds." + cell.kind)
    driver = kind.Driver(cell, seed, device, Spans())
    n = (cell.traffic["distinct_batches"] * driver.B
         if cell.kind == "batch_serve" else cell.traffic["distinct_panos"])
    driver.make_rows(n)
    driver.state_dict = seeded_weights(cell.config, seed, device)
    undo = plant(path) if path in ("floor", "corner") else None
    try:
        served = (fp8_served(driver) if path == "fp8"
                  else program_served(driver, path == "int8"))
    finally:
        if undo:
            undo()
    served = judge_serve.distinct(served, judge_serve.same_output)
    bon, cor = judge_serve.reference_outputs(
        driver.rows, driver.state_dict, driver.H, driver.W, driver.dct,
        device)
    return judge_serve.compare(served, bon, cor, driver.H, driver.W)


def train_readings(cell, seed, path, device):
    """The train cell: ``bf16`` the program's checked steps (its set-up),
    ``fp8`` the reference in float8 in its place, ``half`` the reference
    with half of each batch left out (the mean taken over the rest),
    ``ascent`` the reference with its updates taken the wrong way."""
    from harness import judge_train
    from harness.kinds.train import Driver, make_rooms
    from harness.trace import Spans
    from harness.weights import seeded_weights
    from reference.model import fp8
    from reference.train import Adam

    class Ascent(Adam):
        def step(self, grads):
            super().step({k: -g for k, g in grads.items()})

    d = Driver(cell, seed, device, Spans())
    if path == "bf16":
        d.setup()
        d.release()
        mine = {"losses": d.losses, "grad1": d.grad1, "params3": d.params3}
    else:
        d._plans = []
        d.imgs, d.cors = make_rooms(seed, d.n_rooms, d.H, d.W)
        d.state_dict = seeded_weights(cell.config, seed, device)
        mine = judge_train.reference_steps(
            d, **{"fp8": {"lowp": fp8}, "half": {"rows": slice(0, d.B // 2)},
                  "ascent": {"adam": Ascent}}[path])
    return judge_train.gaps(mine, judge_train.reference_steps(d))


def readings(cell, seed, path, device):
    """{number: reading} of ``path`` in the program's place."""
    if cell.kind == "train":
        return train_readings(cell, seed, path, device)
    return serve_readings(cell, seed, path, device)


def main(argv):
    import torch

    from harness.cell import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--path", nargs="+", default=["bf16", "fp8"],
                   choices=("bf16", "fp8", "int8", "half", "ascent",
                            "floor", "corner"))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    for seed in a.seeds:
        for path in a.path:
            r = readings(cell, seed, path, torch.device("cuda", 0))
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "path": path, "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
