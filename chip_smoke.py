#!/usr/bin/env python3
"""Drive the PyTorch port (horizonnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --phases kernel  # a subset, while iterating

Phases; any failed check makes the script exit non-zero:
  kernel    build K1 (csrc/bilstm_fwd.cu) from the checkout and hold it
            against its plain PyTorch twin: f32 at a small shape (abs tol
            1e-5) and bf16 at the serving shape T=256, D=2, B=64, H=512
            (abs tol 1e-2, the bf16 output rounding); times it beside the
            twin and beside cuDNN's nn.LSTM on the same weights.
  golden    the committed resnet18_rnn_synth.ckpt on val_room through
            InferenceEngine(postproc="cuboid") in f32 with TF32 off:
            corners within 2 px and z1 within 0.2 of golden_outputs.npz;
            then bf16, whose corner drift is printed.
  flagship  resnet50_rnn at full width, bf16, random weights from seed 0,
            batch 64, dct4 wire of val_room rolled per sample, through
            serve_stream at depth 3: finite [8, 2] corners; serving and
            device-resident panos/s.
  cli       python -m horizonnet_tpu_torch.cli.inference on the golden,
            JSON within 2 px of golden_outputs.npz.

Before the last line it prints the card's name and power limit, and one
JSON line {"kernels": [...]} with each kernel's launches on the main path
(the flagship run), its error against the twin and its time beside the
twin's. The last line is {"ok": true, "device": {...}}. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden")
PHASES = ("kernel", "golden", "flagship", "cli")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() over reps, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_kernel(state):
    import torch
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.ops.lstm import bidir_layer

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def inputs(T, D, B, H, dtype):
        xw = torch.randn(T, D, B, 4 * H, generator=g)
        k = H ** -0.5
        w = (torch.rand(D, H, 4 * H, generator=g) * 2 - 1) * k
        return xw.to(dev, dtype), w.to(dev, dtype)

    # f32, small shape
    xw, w = inputs(16, 2, 3, 32, torch.float32)
    err32 = (cuda_lstm.bilstm_recurrence_cuda(xw, w)
             - cuda_lstm.bilstm_recurrence_plain(xw, w)).abs().max().item()
    torch.cuda.synchronize()
    log(f"K1 f32 [T=16,D=2,B=3,H=32] max|kernel - twin| = {err32:.3e} "
        "(tol 1e-5)")
    check(err32 <= 1e-5, f"K1 f32 error {err32} > 1e-5")

    # bf16, serving shape
    T, D, B, H = 256, 2, 64, 512
    xw, w = inputs(T, D, B, H, torch.bfloat16)
    ys_k = cuda_lstm.bilstm_recurrence_cuda(xw, w)
    ys_p = cuda_lstm.bilstm_recurrence_plain(xw, w)
    errbf = (ys_k.float() - ys_p.float()).abs().max().item()
    log(f"K1 bf16 [T={T},D={D},B={B},H={H}] max|kernel - twin| = "
        f"{errbf:.3e} (tol 1e-2: bf16 output rounding)")
    check(bool(torch.isfinite(ys_k.float()).all()), "K1 bf16 output not finite")
    check(errbf <= 1e-2, f"K1 bf16 error {errbf} > 1e-2")

    ms_k = cuda_ms(lambda: cuda_lstm.bilstm_recurrence_cuda(xw, w))
    ms_p = cuda_ms(lambda: cuda_lstm.bilstm_recurrence_plain(xw, w), reps=5)
    log(f"K1 recurrence bf16 serving shape: kernel {ms_k:.3f} ms, plain twin "
        f"{ms_p:.3f} ms (CUDA events, median) [{state['card']}]")

    # One whole bidirectional layer (projection + recurrence) against
    # cuDNN's nn.LSTM on the same weights: the comparator, not a twin
    I = 1024
    x = torch.randn(T, B, I, generator=g).to(dev, torch.bfloat16)
    k = H ** -0.5
    p = {"w_ih": ((torch.rand(D, 4 * H, I, generator=g) * 2 - 1) * k),
         "w_hh": ((torch.rand(D, 4 * H, H, generator=g) * 2 - 1) * k),
         "b": ((torch.rand(D, 4 * H, generator=g) * 2 - 1) * k)}
    p = {n: v.to(dev) for n, v in p.items()}
    ref = torch.nn.LSTM(I, H, num_layers=1, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(ref, "weight_ih_l0" + sfx).copy_(p["w_ih"][d])
            getattr(ref, "weight_hh_l0" + sfx).copy_(p["w_hh"][d])
            getattr(ref, "bias_ih_l0" + sfx).copy_(p["b"][d])
            getattr(ref, "bias_hh_l0" + sfx).zero_()
    ref = ref.to(torch.bfloat16)
    with torch.no_grad():
        y_port = bidir_layer(x, p, "kernel")
        y_cudnn = ref(x)[0]
        diff = (y_port.float() - y_cudnn.float()).abs().max().item()
        ms_layer = cuda_ms(lambda: bidir_layer(x, p, "kernel"))
        ms_cudnn = cuda_ms(lambda: ref(x))
    log(f"bi-LSTM layer bf16 [T={T},B={B},I={I},H={H}]: port (matmul + K1) "
        f"{ms_layer:.3f} ms; comparator cuDNN nn.LSTM {ms_cudnn:.3f} ms; "
        f"max|port - cuDNN| = {diff:.3e} [{state['card']}]")
    state["kernels"]["bilstm_fwd"].update(
        max_abs_err=max(err32, errbf), ms=ms_k, plain_ms=ms_p)


def _golden_inputs():
    import numpy as np
    from horizonnet_tpu_torch.utils.image import read_png

    img = read_png(os.path.join(GOLDEN, "val_room.png"))[..., :3]
    want = np.load(os.path.join(GOLDEN, "golden_outputs.npz"))
    return img, want


def phase_golden(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    img, want = _golden_inputs()
    x = img[None].astype(np.float32) / 255.0
    ckpt = os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt")
    for dtype in (torch.float32, torch.bfloat16):
        model, sd = load_trained_model(ckpt, device="cuda", dtype=dtype)
        eng = InferenceEngine(model, sd, batch_size=1, postproc="cuboid",
                              device="cuda")
        before = cuda_lstm.launches
        cid, z1 = unpack_cuboid_outputs(eng(x))
        dpx = float(np.abs(cid[0] - want["cuboid_uv"]).max() * 512)
        dz1 = abs(float(z1[0]) - float(want["cuboid_z1"]))
        ran = cuda_lstm.launches - before
        name = str(dtype).split(".")[-1]
        log(f"golden {name}: corners {dpx:.4f} px from golden_outputs.npz, "
            f"|dz1| {dz1:.4f}, K1 launches {ran}"
            + (" (TF32 off)" if dtype == torch.float32 else ""))
        check(ran > 0, f"golden {name}: K1 was not launched")
        if dtype == torch.float32:
            check(dpx < 2.0, f"golden f32 corners off by {dpx} px")
            check(dz1 < 0.2, f"golden f32 z1 off by {dz1}")


def phase_flagship(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.inference import InferenceEngine, serve_stream
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.ops.dct import pack_dct4
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs

    B, n_distinct, n_batches, reps = 64, 3, 12, 3
    img, _ = _golden_inputs()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    wire = []
    for _ in range(n_distinct):
        rolls = rng.integers(0, img.shape[1], B)
        wire.append(pack_dct4(np.stack([np.roll(img, r, axis=1)
                                        for r in rolls])))
    log(f"flagship: packed {n_distinct} dct4 batches of {B} in "
        f"{time.perf_counter() - t0:.1f} s ({wire[0].nbytes / B / 1024:.1f} "
        "KiB/pano)")

    model = build_model("resnet50", True, device="cuda",
                        dtype=torch.bfloat16, lstm_impl="kernel", seed=0)
    eng = InferenceEngine(model, model.state_dict(), batch_size=B,
                          postproc="cuboid", input_format="dct4",
                          device="cuda")

    def finish(outs):
        return unpack_cuboid_outputs(outs)

    def check_results(results):
        for cid, z1 in results:
            check(cid.shape == (B, 8, 2) and z1.shape == (B,),
                  f"flagship result shapes {cid.shape} {z1.shape}")
            check(bool(np.isfinite(cid).all() and np.isfinite(z1).all()),
                  "flagship result not finite")

    t0 = time.perf_counter()
    check_results(list(serve_stream(eng, iter(wire), depth=3,
                                    finish=finish)))
    torch.cuda.synchronize()
    log(f"flagship warm-up ({n_distinct} batches): "
        f"{time.perf_counter() - t0:.1f} s")

    feed = [wire[i % n_distinct] for i in range(n_batches)]
    serving = []
    cuda_lstm.launches = 0
    for _ in range(reps):
        t0 = time.perf_counter()
        results = list(serve_stream(eng, iter(feed), depth=3, finish=finish))
        serving.append(n_batches * B / (time.perf_counter() - t0))
        check(len(results) == n_batches, "serve_stream lost batches")
        check_results(results)
    launches = cuda_lstm.launches
    check(launches > 0, "K1 was not launched on the main path")
    state["kernels"]["bilstm_fwd"]["launches"] = launches

    xs = [eng.put(w) for w in wire]
    torch.cuda.synchronize()
    device = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(n_batches):
            eng.run(xs[i % n_distinct])
        torch.cuda.synchronize()
        device.append(n_batches * B / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"flagship resnet50_rnn bf16 B={B} dct4 cuboid: serving "
        f"{statistics.median(serving):.1f} panos/s (median of {reps} runs "
        f"of {n_batches} batches, depth 3; runs "
        f"{[round(v, 1) for v in serving]}), device-resident "
        f"{statistics.median(device):.1f} panos/s (runs "
        f"{[round(v, 1) for v in device]}), peak memory {peak:.1f} GiB, "
        f"K1 launches {launches} [{state['card']}]")


def phase_cli(state):
    import numpy as np

    _, want = _golden_inputs()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as out:
        cmd = [sys.executable, "-m", "horizonnet_tpu_torch.cli.inference",
               "--pth", os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt"),
               "--img_glob", os.path.join(GOLDEN, "val_room.png"),
               "--output_dir", out, "--device_postproc", "--force_cuboid",
               "--device", "cuda"]
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0,
              f"CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(os.path.join(out, "val_room.json")) as f:
            got = json.load(f)
    dpx = float(np.abs(np.asarray(got["uv"]) - want["cuboid_uv"]).max() * 512)
    log(f"cli: val_room.json corners {dpx:.4f} px from golden_outputs.npz")
    check(dpx < 2.0, f"CLI corners off by {dpx} px")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", nargs="+", default=list(PHASES),
                    choices=PHASES)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "horizonnet_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from horizonnet_tpu_torch.ops import cuda_lstm

    state = {"card": card_line(), "kernels": {"bilstm_fwd": {
        "name": "bilstm_fwd", "route": "cuda",
        "source": "horizonnet_tpu_torch/csrc/bilstm_fwd.cu",
        "replaces": "horizonnet_tpu/ops/pallas_lstm.py:31",
        "launches": None, "max_abs_err": None, "ms": None,
        "plain_ms": None}}}
    log(state["card"])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda_lstm.build()
    log(f"K1 build (nvcc, or the cached library): "
        f"{time.perf_counter() - t0:.1f} s")

    phases = {"kernel": phase_kernel, "golden": phase_golden,
              "flagship": phase_flagship, "cli": phase_cli}
    for name in args.phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        phases[name](state)
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")

    print(json.dumps({"kernels": list(state["kernels"].values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
