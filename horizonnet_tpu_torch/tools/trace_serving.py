#!/usr/bin/env python3
"""Per-kernel device-time breakdown of the port's serving program.

Counterpart of tools/trace_serving.py, with the same arguments: it builds
the flagship engine (resnet50_rnn, bf16, the CUDA LSTM kernel, random
weights from seed 0; wire decode, forward and the fused postprocess in one
InferenceEngine.run), feeds it val_room.png rolled per sample, and after
one warm-up batch profiles S batches with torch.profiler (CUDA activity).
It prints the device kernels (memory copies and sets included) by device
time a batch, each one's share of a batch, and the device-busy share: the
union of the kernels' intervals over the span from the first kernel's
start to the last one's end. The last line is the same as JSON. The
engine replays its captured CUDA graph, and the profiler records each
kernel of a replay as it records an eager launch.

    python3 horizonnet_tpu_torch/tools/trace_serving.py \\
        [batch] [fmt] [postproc] [top_n]

fmt is an InferenceEngine input format (float, uint8, yuv420, dct, dct4),
postproc cuboid or general; the defaults are JAX's: 32 dct cuboid 35.
"""

import collections
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PANO = os.path.join(REPO, "tests", "fixtures", "golden", "val_room.png")


def demo_batch(B, fmt, seed=0):
    """B copies of val_room.png, each rolled by a column shift drawn from
    ``seed``, packed as ``fmt``."""
    from horizonnet_tpu_torch.utils.image import load_pano

    img = load_pano(PANO)
    rolls = np.random.default_rng(seed).integers(0, img.shape[1], B)
    x = np.stack([np.roll(img, r, axis=1) for r in rolls])
    if fmt == "float":
        return x.astype(np.float32) / 255.0
    if fmt == "yuv420":
        from horizonnet_tpu_torch.ops.yuv import pack_yuv420
        return pack_yuv420(x)
    if fmt in ("dct", "dct4"):
        from horizonnet_tpu_torch.ops import dct
        return (dct.pack_dct if fmt == "dct" else dct.pack_dct4)(x)
    return x


def capture(B=32, fmt="dct", postproc="cuboid", S=8):
    """Profile S engine runs on the card after one warm-up: (device
    events as [(name, start_us, end_us)], S)."""
    import torch
    from torch.autograd import DeviceType

    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.utils.profiling import trace_profile

    model = build_model("resnet50", True, device="cuda",
                        dtype=torch.bfloat16, lstm_impl="kernel", seed=0)
    engine = InferenceEngine(model, model.state_dict(), batch_size=B,
                             postproc=postproc, input_format=fmt,
                             device="cuda")
    x_dev = engine.put(demo_batch(B, fmt))
    engine.run(x_dev)                                         # warm-up
    torch.cuda.synchronize()
    with trace_profile("cuda") as prof:
        for _ in range(S):
            engine.run(x_dev)
        torch.cuda.synchronize()
        time.sleep(0.2)         # the last kernel records reach it late
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    return events, S


def summarize(events, S):
    """Device ms a batch by kernel name, the busy ms a batch (the union
    of the intervals) and the span a batch (first start to last end)."""
    by_name = collections.Counter()
    for name, t0, t1 in events:
        by_name[name] += (t1 - t0) / 1e3 / S
    busy = span = 0.0
    if events:
        ivs = sorted((t0, t1) for _, t0, t1 in events)
        lo, hi = ivs[0]
        for t0, t1 in ivs[1:]:
            if t0 > hi:
                busy += hi - lo
                lo, hi = t0, t1
            else:
                hi = max(hi, t1)
        busy += hi - lo
        span = hi - ivs[0][0]
    return by_name, busy / 1e3 / S, span / 1e3 / S


def report(events, S, top_n=35):
    """Print the top_n kernels by device ms a batch and return the
    summary (the JSON line's object)."""
    by_name, busy, span = summarize(events, S)
    share = busy / span if span else 0.0
    print(f"device busy {busy:.3f} ms a batch of a {span:.3f} ms span "
          f"({100 * share:.1f} % busy) over {S} batches; "
          f"{len(by_name)} kernels; top {top_n}:")
    print(f"{'ms/batch':>10}  {'%':>5}  kernel")
    for name, ms in by_name.most_common(top_n):
        pct = 100 * ms / span if span else 0.0
        print(f"{ms:10.3f}  {pct:5.1f}  {name[:100]}")
    return {"batches": S, "busy_ms": busy, "span_ms": span,
            "busy_share": share,
            "kernels": {n[:160]: ms for n, ms in by_name.most_common()}}


def main(argv=None):
    a = sys.argv[1:] if argv is None else argv
    B = int(a[0]) if a else 32
    fmt = a[1] if len(a) > 1 else "dct"
    postproc = a[2] if len(a) > 2 else "cuboid"
    top = int(a[3]) if len(a) > 3 else 35
    events, S = capture(B, fmt, postproc)
    print(f"resnet50_rnn bf16 B={B} {fmt} {postproc}")
    print(json.dumps(report(events, S, top)))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
