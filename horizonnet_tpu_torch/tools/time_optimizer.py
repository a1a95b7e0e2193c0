#!/usr/bin/env python3
"""Time the train step's optimizer update, captured as a CUDA graph, on the
resnet50_rnn parameters (float32, as the train CLI keeps them).

    python3 horizonnet_tpu_torch/tools/time_optimizer.py [--reps 50]

Prints one line of CUDA-event medians, each over ``--reps`` replays of a
graph that holds one update:

``update``        train/step.py::Optimizer.step, Adam on the warmup-poly
                  schedule: the count, learning rate and bias corrections
                  on the device, the moments, and the apply.
``apply_addcmul`` the apply alone as the update takes it: p + u * (-lr)
                  with -lr a 0-dim device tensor, one rounding
                  (``_foreach_addcmul_``, one kernel per parameter).
``apply_alpha``   the apply as a host learning rate allows it: an add with
                  alpha=-lr, one rounding, multi-tensor kernels (a capture
                  would freeze lr).
``apply_mul_add`` -lr multiplied into u, then added: multi-tensor kernels,
                  but two roundings, so not the host-float update's bits.

The card's name and power limit come first, from nvidia-smi.
"""

import argparse
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def replay_ms(fn, reps):
    """Median ms of ``reps`` replays of ``fn`` captured once."""
    import torch

    fn = torch.no_grad()(fn)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        fn()
    t = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        t.append(e0.elapsed_time(e1))
    return statistics.median(t)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)

    import torch

    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    model = build_model("resnet50", True, device="cuda",
                        dtype=torch.bfloat16, lstm_impl="kernel_train",
                        param_dtype=torch.float32, seed=0)
    opt = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(1e-4, 1000))).opt
    g = torch.Generator(device="cuda").manual_seed(0)
    ps = list(opt.params.values())
    for q in ps:
        q.grad = torch.randn(q.shape, device="cuda", generator=g) * 1e-3
    upd = [torch.randn(q.shape, device="cuda", generator=g) for q in ps]
    neg_lr = torch.full((), -1e-9, device="cuda")

    def mul_add():
        u = torch._foreach_mul(upd, neg_lr)
        torch._foreach_add_(ps, u)

    ms = {
        "update": replay_ms(opt.step, args.reps),
        "apply_addcmul": replay_ms(
            lambda: torch._foreach_addcmul_(ps, upd, [neg_lr] * len(ps)),
            args.reps),
        "apply_alpha": replay_ms(
            lambda: torch._foreach_add_(ps, upd, alpha=-1e-9), args.reps),
        "apply_mul_add": replay_ms(mul_add, args.reps),
    }
    n = sum(q.numel() for q in ps)
    print(f"optimizer update, captured, {len(ps)} parameter tensors, {n} "
          "float32 values: " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
