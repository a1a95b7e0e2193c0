"""Device milliseconds a train step of K5, the encoder's wrap pad and its
fold (horizonnet_tpu_torch/csrc/wrap_pad.cu): each kernel's traced
seconds, over the launches the profiler saw times those the program
counted (``pad.fwd_launches``, ``pad.bwd_launches``), summed and divided
by the window's replays of the captured step. Nothing where the profiler
saw more launches of a kernel than were counted, or under SEEN of them,
as harness/kernels.py reads the LSTM kernels, and nothing from a program
without K5's counters."""

import sys

from harness.kernels import SEEN

#: (profiler name test, launch counter) of the pad and the fold
KERNELS = ((lambda n: "wrap_pad::pad_fwd<" in n, "pad.fwd_launches"),
           (lambda n: "wrap_pad::fold_bwd<" in n, "pad.bwd_launches"))


def read(run):
    replays = run.launches.get("program.replays")
    if not replays:
        return None
    total = 0.0
    for match, counter in KERNELS:
        seen, seconds = run.kernel_seconds(match)
        counted = run.launches.get(counter, 0)
        print(f"{counter}: traced {seen}, counted {counted}",
              file=sys.stderr)
        if counted == 0 or not SEEN * counted <= seen <= counted:
            return None
        total += seconds / seen * counted
    return 1e3 * total / replays
