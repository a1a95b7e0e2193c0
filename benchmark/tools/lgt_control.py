#!/usr/bin/env python3
"""Readings of the LGT-Net training cell's control and planted faults,
for setting its limits.

    python3 benchmark/tools/lgt_control.py --workload lgt-mp3d-train-b24 \
        --seeds 1 2 3 [--path bf16 fp8 no_rg unshifted rw_transposed] \
        [--leaves leaves.jsonl]

For each seed and path, one JSON line with the judge's numbers
(harness/judge_lgt_train.py::readings): ``bf16`` the program's checked
steps (the sound readings), ``fp8`` the float32 reference computed with
float8 operands, and each planted fault of reference/lgt.py in the
program's place; the witnesses ``f32`` (the program in float32, TF32
off) and ``ref_bf16`` (the reference with bf16 operands) show where the
sound readings come from. A path named twice runs twice. The reference's
own steps are worked out once a seed. ``--leaves`` also writes each
leaf's numbers (judge_lgt_train.leaf_numbers), a line a seed and path.
Not part of a benchmark run; it needs the card at the cell's own size.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))
sys.path.insert(0, BENCH)


def main(argv):
    import torch

    from harness.cell import load_cell
    from harness.judge_lgt_train import (PATHS, WITNESSES, _base, gaps,
                                         leaf_numbers, path_steps,
                                         reference_steps)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="lgt-mp3d-train-b24")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--path", nargs="+", default=list(PATHS),
                   choices=PATHS + WITNESSES)
    p.add_argument("--leaves", help="a file for each leaf's numbers")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    device = torch.device("cuda", 0)
    leaves = open(a.leaves, "a") if a.leaves else None
    for seed in a.seeds:
        ref = reference_steps(_base(cell, seed, device))
        torch.cuda.empty_cache()
        for path in a.path:
            mine = path_steps(cell, seed, path, device)
            torch.cuda.empty_cache()
            line = {"workload": a.workload, "seed": seed, "path": path}
            print(json.dumps({**line, "readings": gaps(mine, ref)}),
                  flush=True)
            if leaves:
                loss, each = leaf_numbers(mine, ref)
                leaves.write(json.dumps({**line, "loss_gap": loss,
                                         "leaves": each}) + "\n")
                leaves.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
