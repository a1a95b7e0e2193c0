#!/usr/bin/env python3
"""Device time of one train step by kernel, and the wrap pad's share of it.

Builds the ST3D recipe's step (HorizonNet, resnet50 by default, bf16 on
float32 parameters, K2/K3, batch 24 at 512x1024, random weights from seed
0, synthetic rooms) with ``TrainEngine(graph=False)``, so that every
kernel is launched by an aten op the profiler sees, warms it up, then
profiles ``steps`` eager steps with CPU and CUDA activity. Each kernel is
attributed through the aten op that launched it and that op's enclosing
ops:

- ``pad.fwd``: inside ``wrap_pad_width`` (models/layers.py's WrapPad and
  the seam-free pool; marked here by a ``record_function`` around it);
- ``pad.bwd``: inside the autograd node of an op that ran in that scope
  (matched by sequence number): the gradient of the pad, with the
  accumulation of its parts into the input's gradient;
- ``other``: the rest of the step.

It prints the step's device milliseconds by category and, for the largest
kernels, each category's milliseconds a step, with the innermost aten op
of the pad's part (``aten::copy_``, ``aten::fill_``, ``aten::add_``, ...).
The last line is the same as JSON; ``--out`` writes it to a file too. On
the CPU (``--device cpu``, a smoke run of the control flow) each aten op
stands in for a kernel, with its own CPU time.

    python3 benchmark/tools/trace_wrap_pad.py [--batch 24]
        [--width 1024] [--backbone resnet50] [--steps 2] [--device cuda]
        [--out FILE]
"""

import argparse
import collections
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

PAD_SCOPE = "wrap_pad"
EVAL = "autograd::engine::evaluate_function: "


def _ancestors(ev):
    while ev is not None:
        yield ev
        ev = ev.cpu_parent


def attribute(events, on_card):
    """[(category, innermost op, kernel name, device us)] of every kernel
    in ``events`` (a profiler's FunctionEvents)."""
    cpu = [e for e in events if e.device_type.name == "CPU"]
    pad_seq = {e.sequence_nr for e in cpu if e.sequence_nr >= 0
               and any(a.name == PAD_SCOPE for a in _ancestors(e))}
    out = []
    for e in cpu:
        if on_card:
            kernels = [(k.name, k.duration) for k in e.kernels]
        elif e.name != PAD_SCOPE and not e.name.startswith(EVAL):
            kernels = [(e.name, e.self_cpu_time_total)]
        else:
            kernels = []
        if not kernels:
            continue
        chain = list(_ancestors(e))
        if any(a.name == PAD_SCOPE for a in chain):
            cat = "pad.fwd"
        elif any(a.name.startswith(EVAL) and a.sequence_nr in pad_seq
                 for a in chain):
            cat = "pad.bwd"
        else:
            cat = "other"
        out += [(cat, e.name, name, us) for name, us in kernels]
    return out


def summarize(rows, steps, top=25):
    """The JSON record: ms a step by category, and the ``top`` kernels by
    ms a step with each category's part (the pad's by innermost op)."""
    by_cat = collections.Counter()
    by_kernel = collections.defaultdict(collections.Counter)
    for cat, op, name, us in rows:
        by_cat[cat] += us / 1e3 / steps
        part = cat if cat == "other" else f"{cat} {op}"
        by_kernel[name[:200]][part] += us / 1e3 / steps
    total = sum(by_cat.values())
    kernels = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1].values()))
    return {"step_device_ms": total,
            "by_category_ms": dict(by_cat),
            "pad_share_pct": 100.0 * (by_cat["pad.fwd"] + by_cat["pad.bwd"])
            / max(total, 1e-12),
            "kernels": [{"name": k, "ms": sum(v.values()), "parts": dict(v)}
                        for k, v in kernels[:top]]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from horizonnet_tpu_torch.data.synth import synth_batch
    from horizonnet_tpu_torch.models import build_model, layers
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)

    dev = torch.device(a.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    pad = layers.wrap_pad_width

    def marked(*args, **kw):
        with record_function(PAD_SCOPE):
            return pad(*args, **kw)
    layers.wrap_pad_width = marked

    H, W, B = 512, a.width, a.batch
    imgs, y_bon, y_cor, _ = synth_batch(np.random.default_rng(0), B, H, W)
    model = build_model(a.backbone, True, device=dev, dtype=torch.bfloat16,
                        lstm_impl="kernel_train" if on_card else "plain",
                        param_dtype=torch.float32, seed=0)
    tx = make_optimizer("Adam", warmup_poly_schedule(3e-4, max_iters=10000))
    state = create_train_state(model, tx)
    engine = TrainEngine(model, state, B, H, W, device=dev, graph=False)
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev)
    ys = (torch.from_numpy(y_bon).to(dev), torch.from_numpy(y_cor).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    for _ in range(2):
        engine.step(x, *ys, gen)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        for _ in range(a.steps):
            engine.step(x, *ys, gen)
        sync()
    rec = summarize(attribute(prof.events(), on_card), a.steps)
    rec.update(batch=B, width=W, backbone=a.backbone, steps=a.steps,
               device=(torch.cuda.get_device_name(dev) if on_card
                       else "cpu"))
    print(f"step device ms {rec['step_device_ms']:.3f}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      rec["by_category_ms"].items())
          + f"; pad {rec['pad_share_pct']:.2f} %")
    for k in rec["kernels"]:
        print(f"{k['ms']:9.3f} ms  {k['name']}")
        for part, ms in sorted(k["parts"].items(), key=lambda kv: -kv[1]):
            print(f"{'':14}{ms:9.3f}  {part}")
    line = json.dumps(rec)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
