"""Sustained training throughput at the reference recipe, on the card.

Reference recipe (README_ST3D.md:24): resnet50_rnn, batch 24, 512x1024,
Adam 3e-4 (the warmup-poly schedule over 10000 iterations), bf16 compute
on f32 parameters. The counterpart of the JAX package's
tools/train_throughput.py: the same arguments, defaults and figures.
TrainEngine captures the step once (train/engine.py) and every step
replays it. Reported, over measured steps after one warm-up step:

- device-resident: ms a step and panos/s with the batch already on the
  card (one ``synchronize`` after the run of steps);
- the multi-step figure: JAX runs 8 steps inside one compiled
  ``lax.scan`` so that no dispatch returns to the host between them. A
  replay of the captured step does not return to the host either, so here
  the figure is 8 replays with one ``synchronize`` after them, with no
  graph of 8 steps;
- host-fed: the batch uploaded every step, as float32 (the engine's
  pinned upload ring), uint8 (cast and scaled on the card), and the dct /
  dct4 wires (packed on the host, decoded on the card by
  ops/dct.py::unpack_dct_to_rgb / unpack_dct4_to_rgb);
- MFU: the step's FLOP count (utils/flops.py: forward with dropout,
  losses and backward; the optimizer left out) over the multi-step time,
  against the H100's dense bf16 rate;
- peak memory over the engine's build and every step.

It prints JAX's text lines, then one JSON line with the same figures.

Usage: python horizonnet_tpu_torch/tools/train_throughput.py [steps] [batch]
           [backbone] [dtype] [lstm_impl] [device]
(dtype: f32 | bf16, the train CLI's --bf16; lstm_impl: scan (the plain
twin) | pallas_train (K2/K3), the train CLI's --lstm_impl; device: cuda by
default, cpu for a smoke run of the control flow, which measures no card
and reports no MFU)
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

#: steps a multi-step run (JAX's fused scan length)
MULTI_STEPS = 8


def measure(steps=30, bs=24, backbone="resnet50", dtype="bf16",
            lstm_impl="scan", device="cuda", H=512, W=1024, n_host=None,
            n_multi=None, emit=print):
    """Time the modes at the recipe; ``emit`` takes each output line.
    ``n_host`` steps a host-fed mode and ``n_multi`` runs of MULTI_STEPS
    default to JAX's max(4, steps // 4) and max(2, steps // 8). Returns
    the JSON line's record."""
    import torch

    from horizonnet_tpu_torch.cli.train import LSTM_IMPLS
    from horizonnet_tpu_torch.data.synth import synth_batch
    from horizonnet_tpu_torch.inference import resolve_device
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.ops import launch_counts
    from horizonnet_tpu_torch.ops.dct import (pack_dct, pack_dct4,
                                              unpack_dct4_to_rgb,
                                              unpack_dct_to_rgb)
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)
    from horizonnet_tpu_torch.utils.flops import (PEAK_BF16_FLOPS, mfu_pct,
                                                  train_step_flops)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    emit(f"generating {bs}-pano synthetic batch...")
    imgs, y_bon, y_cor, _ = synth_batch(rng, bs, H, W)

    launch_counts.reset()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(backbone, True, device=dev,
                        dtype=(torch.bfloat16 if dtype == "bf16"
                               else torch.float32),
                        lstm_impl=LSTM_IMPLS[lstm_impl],
                        param_dtype=torch.float32, seed=0)
    tx = make_optimizer("Adam", warmup_poly_schedule(3e-4, max_iters=10000))
    state = create_train_state(model, tx)
    t0 = time.perf_counter()
    engine = TrainEngine(model, state, bs, H, W, device=dev)
    emit(f"train engine build: {time.perf_counter() - t0:.0f}s (on the "
         f"card the step's warm-up and capture)")
    flops = train_step_flops(model, bs, H, W)

    def pinned(a):
        t = torch.from_numpy(a)
        return t.pin_memory() if on_card else t

    x_host = imgs.astype(np.float32) / 255.0
    x_dev = torch.from_numpy(x_host).to(dev)
    labels_dev = (torch.from_numpy(y_bon).to(dev),
                  torch.from_numpy(y_cor).to(dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    last = {}

    def timed(n, batch):
        """Seconds a step over n steps on ``batch()``'s (x, y_bon, y_cor),
        one synchronize after them."""
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            last["m"] = engine.step(*batch(), gen)
        sync()
        return (time.perf_counter() - t0) / n

    resident = lambda: (x_dev, *labels_dev)  # noqa: E731
    timed(1, resident)                       # warm-up
    dt_dev = timed(steps, resident)

    n_host = max(4, steps // 4) if n_host is None else n_host
    dt_host = timed(n_host, lambda: (x_host, y_bon, y_cor))

    # uint8 upload, normalized on the card: what the CLI's augmentation
    # path ships (data/augment.py)
    u8 = pinned(imgs)

    def cast():
        return u8.to(dev, non_blocking=True).float() / 255.0
    cast()
    dt_u8 = timed(n_host, lambda: (cast(), y_bon, y_cor))

    # the compressed wires: packed on the host, decoded on the card, the
    # train CLI's --wire dct and --wire dct4
    packed = {"dct": pack_dct(imgs), "dct4": pack_dct4(imgs)}
    unpack = {"dct": unpack_dct_to_rgb, "dct4": unpack_dct4_to_rgb}
    dt_wire = {}
    for wire, p in packed.items():
        p_t = pinned(p)

        def decode(p_t=p_t, fn=unpack[wire]):
            return fn(p_t.to(dev, non_blocking=True), H, W)
        decode()
        dt_wire[wire] = timed(n_host, lambda: (decode(), y_bon, y_cor))

    n_multi = max(2, steps // MULTI_STEPS) if n_multi is None else n_multi
    dt_multi = timed(n_multi * MULTI_STEPS, resident)
    losses = {k: float(v) for k, v in last["m"].items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"train losses not finite: {losses}")
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card
                else None)
    mfu = mfu_pct(flops / bs, bs / dt_multi) if on_card else None
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"

    mb = x_host.nbytes / 1e6
    emit(f"\nbackbone={backbone} bs={bs} {H}x{W} {dtype} "
         f"lstm={lstm_impl} ({steps} steps) [{card}]")
    emit(f"device-resident: {dt_dev * 1e3:8.1f} ms/step  "
         f"{bs / dt_dev:7.1f} panos/s")
    emit(f"{MULTI_STEPS}-step replays: {dt_multi * 1e3:8.1f} ms/step  "
         f"{bs / dt_multi:7.1f} panos/s  (captured steps, no return "
         f"to the host between them)")
    if mfu is not None:
        emit(f"  step flops {flops / 1e12:.2f} TF -> "
             f"{flops / dt_multi / 1e12:.1f} TF/s "
             f"({mfu:.1f}% of the H100's bf16 peak)")
    emit(f"host-fed f32:    {dt_host * 1e3:8.1f} ms/step  "
         f"{bs / dt_host:7.1f} panos/s  "
         f"({mb:.0f} MB/step upload; input-bound "
         f"{100 * (1 - dt_dev / dt_host):.0f}% on this link)")
    emit(f"host-fed uint8:  {dt_u8 * 1e3:8.1f} ms/step  "
         f"{bs / dt_u8:7.1f} panos/s  "
         f"({imgs.nbytes / 1e6:.0f} MB/step upload + device "
         f"normalize — the CLI augment path's wire format)")
    for wire, dt in dt_wire.items():
        emit(f"host-fed {wire + ':':6s} {dt * 1e3:8.1f} ms/step  "
             f"{bs / dt:7.1f} panos/s  "
             f"({packed[wire].nbytes / 1e6:.1f} MB/step upload + device "
             f"decode — the CLI's --wire {wire} path)")

    ms = {"device": dt_dev, f"multi_{MULTI_STEPS}": dt_multi,
          "host_f32": dt_host, "host_uint8": dt_u8,
          **{f"host_{w}": dt for w, dt in dt_wire.items()}}
    record = {
        "metric": f"train step ms ({backbone}_rnn {dtype} bs {bs} {H}x{W}, "
                  f"Adam 3e-4, lstm {lstm_impl}; captured step replayed)",
        "ms_per_step": {k: round(v * 1e3, 3) for k, v in ms.items()},
        "panos_per_sec": {k: round(bs / v, 2) for k, v in ms.items()},
        "train_mfu_pct": None if mfu is None else round(mfu, 2),
        "step_gflops": round(flops / 1e9, 3),
        "peak_flops": PEAK_BF16_FLOPS if on_card else None,
        "peak_mem_gib": None if peak_gib is None else round(peak_gib, 3),
        "losses": losses,
        "device": card,
        "kernel_launches": launch_counts.named(),
        "config": {"steps": steps, "batch": bs, "backbone": backbone,
                   "dtype": dtype, "lstm_impl": lstm_impl, "H": H, "W": W},
    }
    emit(json.dumps(record))
    return record


def main(argv):
    a = argv
    measure(int(a[0]) if a else 30, int(a[1]) if len(a) > 1 else 24,
            a[2] if len(a) > 2 else "resnet50",
            a[3] if len(a) > 3 else "bf16",
            a[4] if len(a) > 4 else "scan",
            a[5] if len(a) > 5 else "cuda",
            emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
