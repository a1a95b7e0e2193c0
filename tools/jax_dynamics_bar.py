#!/usr/bin/env python3
"""The JAX package's training-dynamics check at another input size.

Runs tests/test_train_dynamics.py::_run_dynamics (resnet18_rnn from seed
594277, Adam at 3e-4 on the warmup-poly schedule, 150 steps at batch 4
over 8 synthetic batches, then the held-out raw-polygon 3DIoU on 8
synthetic rooms) at H x W instead of the test's 128x256, and prints the
3DIoU with the bar that test's rule gives (the value over 1.7, never
below 0.15):

    JAX_PLATFORMS=cpu python tools/jax_dynamics_bar.py --H 512 --W 1024

The PyTorch port's chip_smoke.py holds its dynamics phase (512x1024) to
the bar this prints for that size.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--H", type=int, default=512)
    ap.add_argument("--W", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import test_train_dynamics as dyn

    dyn.H, dyn.W = args.H, args.W
    t0 = time.perf_counter()
    # threshold 0: the function prints the 3DIoU; the loss must still halve
    dyn._run_dynamics(args.steps, 0.0)
    print(f"{args.steps} steps at {args.H}x{args.W} in "
          f"{time.perf_counter() - t0:.1f} s; bar = max(3DIoU / 1.7, 0.15)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
