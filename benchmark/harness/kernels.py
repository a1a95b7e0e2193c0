"""Roofline shares of the bi-LSTM recurrence kernels from the trace.

A kernel's share is the least time the card could take for one launch's
work (harness/flops.py: one recurrent product a step, every tensor the
launch reads or writes once) over the mean device time of its launches
in the traced window. Its launches are found by name in the profiler's
records and counted by the program's wrappers (ops/launch_counts.py).
The profiler is known to drop a few records, which leaves the mean of
the rest as it was; where it saw more launches than were counted, or
under SEEN of them, the records are not the kernel's and the share is
not reported.
"""

import sys

from harness.flops import recurrence_ops, roofline_pct, tensor_bytes

#: the least share of the counted launches the profiler must have seen
SEEN = 0.95

#: (profiler name test, launch counter) of K1 (serving), K2 (train
#: forward) and K3 (train backward)
KERNELS = {
    "k1": (lambda n: "recurrence_bf16<" in n and "false>" in n,
           "cuda_lstm.launches"),
    "k2": (lambda n: "recurrence_bf16<" in n and "true>" in n,
           "cuda_lstm_train.fwd_launches"),
    "k3": (lambda n: "backward_bf16<" in n, "cuda_lstm_train.bwd_launches"),
}


def mean_launch_seconds(run, kernel):
    """Mean device seconds of ``kernel``'s launches in the traced window,
    or None where the profiler's records do not match the counter."""
    match, counter = KERNELS[kernel]
    seen, seconds = run.kernel_seconds(match)
    counted = run.launches.get(counter, 0)
    print(f"{kernel} launches: traced {seen}, counted {counted}",
          file=sys.stderr)
    if counted == 0 or not SEEN * counted <= seen <= counted:
        return None
    return seconds / seen


def recurrence_roofline(run, kernel, B, T, H=512, D=2):
    """``kernel``'s roofline share in percent, at batch B over T steps.
    K1 reads xw [T, D, B, 4H] and W [D, H, 4H] and writes ys [T, D, B,
    H]; K2 writes the gates [T, D, B, 4H] and cells [T, D, B, H] too; K3
    reads the gates, cells, dy [T, D, B, H] and W and writes dxw [T, D,
    B, 4H]."""
    t = mean_launch_seconds(run, kernel)
    if t is None:
        return None
    g, h, w = T * D * B * 4 * H, T * D * B * H, D * H * 4 * H
    elements = {"k1": (g, w, h), "k2": (g, w, h, g, h),
                "k3": (g, h, h, w, g)}[kernel]
    return roofline_pct(recurrence_ops(T, D, B, H), tensor_bytes(*elements),
                        t)
