#!/usr/bin/env python3
"""Time the PyTorch port's LSTM kernels (K1, K2, K3) at batch 1, 8 and 64.

    python3 horizonnet_tpu_torch/tools/lstm_sweep.py TREE [TREE ...]

TREE is a checkout (or `git archive`) of the repository; the kernels are
built from and run through that tree's horizonnet_tpu_torch, one process
per tree, in the order given, on one CUDA card. Shape: bf16, T=256, D=2,
H=512 (the serving and training recurrences); K1 is the serving forward,
K2 the training forward with its residuals, K3 the backward on K2's
residuals. Times are CUDA-event medians of 10 calls.
"""

import os
import subprocess
import sys

_CHILD = r"""
import statistics, sys, torch
sys.path.insert(0, sys.argv[1])
from horizonnet_tpu_torch.ops import cuda_lstm, cuda_lstm_train as clt
g = torch.Generator().manual_seed(0)
xw = torch.randn(256, 2, 64, 2048, generator=g).cuda().bfloat16()
w = ((torch.rand(2, 512, 2048, generator=g) * 2 - 1) / 512 ** .5).cuda().bfloat16()
dys = torch.randn(256, 2, 64, 512, generator=g).cuda().bfloat16()

def ms(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(10):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        t.append(e0.elapsed_time(e1))
    return statistics.median(t)

out = {"K1": [], "K2": [], "K3": []}
for b in (1, 8, 64):
    xs, ds = xw[:, :, :b].contiguous(), dys[:, :, :b].contiguous()
    _, gates, cs = clt.train_fwd_cuda(xs, w)
    for k, fn in (("K1", lambda: cuda_lstm.bilstm_recurrence_cuda(xs, w)),
                  ("K2", lambda: clt.train_fwd_cuda(xs, w)),
                  ("K3", lambda: clt.train_bwd_cuda(gates, cs, ds, w))):
        out[k].append(f"B={b} {ms(fn):.3f}")
print("; ".join(f"{k} " + ", ".join(v) + " ms" for k, v in out.items()))
"""


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rc = 0
    for tree in trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree],
                              capture_output=True, text=True, cwd=tree)
        line = proc.stdout.strip() or proc.stderr.strip()[-2000:]
        print(f"bf16 T=256 D=2 H=512 ({tree}): {line} [{card}]", flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
