"""Cuboid evaluation CLI (reference eval_cuboid.py:162-202 surface).

Copy of horizonnet_tpu/cli/eval_cuboid.py: the same flags and the same
stdout. Host numpy; it reads the inference CLI's JSONs:

    python -m horizonnet_tpu_torch.cli.eval_cuboid --dt_glob 'out/*.json' \
        --gt_glob 'data/test/label_cor/*txt'
"""

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dt_glob", required=True,
                        help="quoted glob of inference output jsons")
    parser.add_argument("--gt_glob", default="data/test/label_cor/*txt",
                        help="quoted glob of GT corner txts")
    parser.add_argument("--w", default=1024, type=int)
    parser.add_argument("--h", default=512, type=int)
    args = parser.parse_args(argv)

    from ..evals import test_cuboid, prepare_gtdt_pairs

    gtdt_pairs = prepare_gtdt_pairs(args.gt_glob, args.dt_glob)
    losses = {"CE": [], "PE": [], "3DIoU": []}
    for gt_path, dt_path in gtdt_pairs:
        with open(gt_path) as f:
            gt_cor_id = np.array([l.split() for l in f], np.float32)
        with open(dt_path) as f:
            dt = json.load(f)
        dt_cor_id = np.array(dt["uv"], np.float32)
        dt_cor_id[:, 0] *= args.w
        dt_cor_id[:, 1] *= args.h
        test_cuboid(dt_cor_id, dt["z0"], dt["z1"], gt_cor_id,
                    args.w, args.h, losses)

    print(" Testing Result ".center(50, "="))
    print("Corner Error (%):", np.mean(losses["CE"]))
    print("Pixel  Error (%):", np.mean(losses["PE"]))
    print("3DIoU        (%):", np.mean(losses["3DIoU"]))
    print("=" * 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
