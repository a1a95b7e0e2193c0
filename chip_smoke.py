#!/usr/bin/env python3
"""Drive the PyTorch port (horizonnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --phases kernel train train_cli   # a subset
    python3 chip_smoke.py --phases kernel fused general     # K4, general
    python3 chip_smoke.py --phases host dynamics train_cli  # host path,
                                                            # validation
    python3 chip_smoke.py --phases kernel densenet quant    # model options
    python3 chip_smoke.py --phases preprocess               # VP alignment

Phases; any failed check makes the script exit non-zero:
  kernel    build K1 (csrc/bilstm_fwd.cu), the training pair K2/K3
            (csrc/bilstm_train.cu) and the fused bottleneck K4
            (csrc/fused_bottleneck.cu) from the checkout, one nvcc each, in
            parallel, and hold each against its plain PyTorch twin: f32 at
            a small shape (tol 1e-5) and bf16 at the main path's shape (K1
            at serving T=256, D=2, B=64, H=512; K2/K3 at training B=8),
            tol 1e-2 relative to the largest entry (the bf16 output
            rounding: a one-ulp flip is 2^-7 of the value); K1's bf16
            output must also equal the twin's bit for bit on at least
            99.98 % of its entries (its three-term products keep the f32
            contract; products of one or two terms fall below), and at the
            training shape K2's ys, gates and cs on at least 99.98 % and
            K3's dxw on at least 99.97 %; the autograd.Function's
            gradients against torch.autograd through the plain loop (f32,
            training shape, 1e-4 relative: a 256-step chain summed in
            another order). Times each kernel beside its twin, its bound
            (from the shapes: three bf16 products at 989 TFLOP/s, and the
            same as f32 FMAs at 67 TFLOP/s) and cuDNN's nn.LSTM on the
            same weights (K1: layer forward; K2: forward in training; K3:
            backward). K1, K2 and K3 are also timed at B=1, 8 and 64, and
            the profiler must show one kernel per K1, K2 and K3 call.
            K4: f32 at
            tests/test_pallas_block.py's four shapes (2e-5 relative), bf16
            at 8 shapes at the edges of its tile plans and at the four
            resnet50 stage shapes at B=64 (3e-2 relative, the JAX
            package's bars), each stage shape timed beside the twin, its
            bound and the port's unfused Bottleneck in eval (cuDNN convs
            and the ATen tail), with the weight bytes it reads from L2.
  golden    the committed resnet18_rnn_synth.ckpt on val_room through
            InferenceEngine(postproc="cuboid") in f32 with TF32 off:
            corners within 2 px and z1 within 0.2 of golden_outputs.npz;
            then bf16, whose corner drift is printed.
  flagship  resnet50_rnn at full width, bf16, random weights from seed 0,
            batch 64, dct4 wire of val_room rolled per sample, through
            serve_stream at depth 3: finite [8, 2] corners; serving and
            device-resident panos/s.
  fused     the flagship with fused_blocks="kernel" (K4 on the 12
            identity bottlenecks) beside the unfused flagship, same
            weights, in turns: serving and device panos/s, corner drift
            on the first batch, K4 launches (12 per forward); then an f32
            resnet50_rnn at B=1, 512x1024 with randomized batch norm, TF32
            off: fused and unfused bon/cor within 2e-4.
  general   the golden through InferenceEngine(postproc="general") in f32
            (12 corners within 2 px of general_uv, z1 within 0.2), then
            through the yuv420 wire (within 2 px); then the flagship's
            width in general mode (resnet50_rnn bf16 B=64 dct4,
            serve_stream depth 3, finish_general_batch on 4 workers):
            serving and device panos/s, every result finite.
  cli       python -m horizonnet_tpu_torch.cli.inference on the golden,
            cuboid and general, JSON within 2 px of golden_outputs.npz.
  host      the reference's default inference, the host postprocess
            (float64 numpy): the golden through the CLI's main() without
            --device_postproc in f32 with TF32 off, cuboid and general
            (corners within 2 px of golden_outputs.npz, z1 within 0.2);
            --force_raw (2048 corners, the JSON equal to
            postprocess(force_raw=True) on the same outputs); the
            --visualize strip equal to visualize_a_data on the same
            outputs (and the file, where Pillow imports); the checkpoint
            written as reference .pth files (a nonzero bias_hh split off
            the folded bias; with and without the .1 infix; the
            DataParallel training format) giving the .ckpt's JSON. Then
            resnet50_rnn bf16, batch 64, 512x1024 float input, random
            weights from seed 0, val_room rolled per sample, through
            inference(), cuboid and general: finite results, K1 launched
            once per recurrence call (by count, and by the profiler at
            that shape in a fresh process); prints the device ms a batch, the host
            postprocess ms a pano (cuboid, general, force_raw) on one
            thread and panos/s end to end, in turns with the flagship's
            device-postproc serving.
  train     resnet50_rnn at 512x1024, bf16 compute with f32 parameters,
            batch 8, Adam at lr 1e-4 on the warmup-poly schedule,
            lstm_impl kernel_train: synthetic rooms (seed 0) written as a
            PNG dataset, one batch through the uint8-wire augmentation on
            the card, then warm-up and 20 timed steps of TrainEngine on
            that batch. Checks: every loss finite, K2 and K3 launched, the
            loss after the steps below the first step's. Prints train
            panos/s, ms per step, peak memory, per-stage times and the
            profiler's top kernels.
  train_cli python -m horizonnet_tpu_torch.cli.train on 2 synthetic
            512x1024 PNG panos with 2 more to validate on (resnet18, batch
            2, 2 epochs, --save_every 1, --lstm_impl pallas_train): both
            epoch checkpoints load back and differ; validation took the
            real metric path (no [WARN]), checkpoint.ckpt holds a finite
            best score above 0 and a best_model_<e>.ckpt is written; a
            run of 1 epoch then --resume'd to 2 reaches the unbroken
            run's epoch and step (the largest relative difference of a
            weight tensor is printed: cuDNN's backward is not
            bit-reproducible).
  dynamics  tests/test_train_dynamics.py's recipe on the port at 512x1024:
            resnet18_rnn f32 from seed 594277, Adam at 3e-4 on the
            warmup-poly schedule, 150 steps at batch 4 cycling 8 synthetic
            batches, K2/K3. The loss must halve and the held-out
            raw-polygon 3DIoU on 8 synthetic rooms (postprocess and
            test_general, one pano a forward through K1) reach
            DYNAMICS_BAR; the train CLI's validate() on the same rooms
            agrees within 1e-3, without placeholders.
  densenet  densenet121_rnn in the flagship's configuration (bf16, batch
            64, dct4, cuboid, K1) in turns with the resnet50 flagship:
            serving and device panos/s, K1 launched twice a forward, the
            profiler's top kernels; each of densenet121/169/161/201 at B=1,
            f32, TF32 off, randomized batch norm: bon/cor on the card
            within 2e-4 (relative to max(1, |x|)) of the same model's
            forward on the CPU; densenet121 training in the train phase's
            configuration (batch 8, kernel_train, Adam), 3 warm-up and 10
            timed steps: finite and falling losses, K2/K3 launched, ms a
            step, panos/s, peak memory.
  quant     resnet50_rnn with the int8 encoder (quant_int8, the same
            random float weights folded by quantize_state_dict) in the
            flagship's configuration, in turns with the bf16 flagship:
            serving and device panos/s, K1 launched twice a forward, the
            profiler's top kernels; one QuantConvBN at the stem (7x7/2,
            3->64, 512x1024) and at stage 1's 3x3 (64->64, 128x256): its
            int32 sums on the card equal the CPU's bit for bit (8 panos),
            and at B=64 in bf16 it is timed beside WrapConv + BatchNorm2d;
            WrapConv with and without seam_fix at those shapes, timed, the
            outputs equal bit for bit; the golden checkpoint quantized:
            int8 corners within 4 px of the float ones and z1 within 5 % +
            1 (JAX's bar, tests/test_quant.py); the inference CLI with
            --quant_int8 --force_cuboid, host path and --device_postproc,
            within 4 px of golden_outputs.npz.
  preprocess
            the VP-alignment branch: lsd, merge, vote and warp built with
            g++ from the checkout into build/preprocess/ (each must load
            from there; the host warp must be the C++ one, not its numpy
            twin); the device backend's warps on the card against the host
            backend at 512x1024 on val_room (view grays within 0.15, RGB
            views 0.2, float rotation mean 0.05, uint8 rotation under 1 %
            of values: the JAX package's bars between its backends), each
            timed on both; python -m horizonnet_tpu_torch.cli.preprocess
            on val_room and two rotations of it by a known R (yaw/tilt
            (20, 8), (-35, 5)) with the default --device cuda, then with
            HORIZONNET_PREPROCESS_BACKEND=host, then --rgbonly: every
            output written at 512x1024x3 uint8, the backends' VP rows
            within 0.05 deg, the vertical VP within 0.1 deg of R vp0 and
            the horizontals within 1.5 deg; preprocess s/pano one at a
            time with the per-stage split, each backend; then the chain
            (bench.py's e2e recipe): 64 raw panos (the three rooms rolled
            by random columns, seed 1) VP-aligned on min(8, cpu) threads
            and served in batches of 8 through the flagship's engine
            (resnet50_rnn bf16, dct4, cuboid, serve_stream depth 2), host
            and device backends in turns, 3 runs each: e2e panos/s, finite
            corners, K1 launched, and a pano without a VP (served as it
            came) the same in every run of a backend.

Before the last line it prints the card's name and power limit, and one
JSON line {"kernels": [...]} with each kernel's launches on the paths
that run it, summed (K1: the flagship, densenet121 and int8 serving
runs and the preprocess chain; K2, K3: the resnet50 and densenet121 train
runs; K4: the fused run; each counted from 0 just before its run, and
logged by path), its error against the twin, its time beside the twin's,
its bound and the library call's time. K4's times and bound are summed
over the 12 calls of one resnet50 forward (2, 3, 5 and 2 at the four stage
shapes).
The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
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
PHASES = ("kernel", "golden", "flagship", "fused", "general", "cli", "host",
          "train", "train_cli", "dynamics", "densenet", "quant",
          "preprocess")
# H100 SXM peaks: f32 outside the tensor cores, bf16 dense on the tensor
# cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
FLAGSHIP_B = 64
TRAIN_B = 8
# Shares of K2's and K3's bf16 outputs equal to the twins' bit for bit at
# the training shape, set from horizonnet_tpu_torch/tools/split_check.py
# (three terms of the split reach them; two and one do not)
K2_SAME_BAR = 0.9998
K3_SAME_BAR = 0.9997
# Held-out raw-polygon 3DIoU the dynamics phase must reach: the JAX
# package's _run_dynamics (tests/test_train_dynamics.py) at 512x1024
# reached 0.505 (tools/jax_dynamics_bar.py, on a CPU); by that test's rule
# the bar is the measured value over 1.7, and never below 0.15
DYNAMICS_BAR = 0.297
# resnet50's identity bottlenecks per stage, and the stage shapes (NHWC) at
# the flagship's batch of 64 and 512x1024 input
RESNET50_IDENTITY = (2, 3, 5, 2)
STAGES = ((64, 128, 256, 256), (64, 64, 128, 512), (64, 32, 64, 1024),
          (64, 16, 32, 2048))


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


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(least ms for the work, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want):
    """max |got - want| over max(1, max |want|), and max |got - want|."""
    want = want.float()
    d = (got.float() - want).abs().max()
    return (d / want.abs().max().clamp(min=1.0)).item(), d.item()


def lstm_bytes_flops(T, D, B, H, elt, residuals=False, backward=False):
    """Bytes (each input read once, each output written once) and FLOPs
    (the recurrent products) of one K1/K2/K3 call."""
    G = 4 * H
    w = D * H * G * elt
    if backward:   # gates, cs, dy in; dxw out; T-1 products (none at T-1)
        return (2 * T * D * B * G + 2 * T * D * B * H) * elt + w, \
            2.0 * (T - 1) * D * B * H * G
    out = T * D * B * H * elt + (T * D * B * (G + H) * elt if residuals
                                 else 0)
    return T * D * B * G * elt + w + out, 2.0 * T * D * B * H * G


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _launched(state, kernel, path, n):
    """Record ``kernel``'s launches on one path's run, counted from 0 just
    before it; the kernels line sums the paths."""
    check(n > 0, f"{kernel} was not launched on the {path} path")
    paths = state["launches"].setdefault(kernel, {})
    paths[path] = n
    state["kernels"][kernel]["launches"] = sum(paths.values())


def _randomize_bn(model, g):
    """Batch norm parameters and statistics away from identity, drawn from
    the CPU generator ``g``, so that every one of them matters."""
    import torch

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5,
                                                          1.5)):
                    t.copy_(torch.empty(n).uniform_(lo, hi, generator=g))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.empty(n).normal_(0, 0.1, generator=g))


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
    same = (ys_k == ys_p).float().mean().item()
    log(f"K1 bf16 [T={T},D={D},B={B},H={H}] max|kernel - twin| = "
        f"{errbf:.3e} (tol 1e-2: bf16 output rounding); {100 * same:.4f} % "
        "of outputs equal the twin's bit for bit (at least 99.98 %)")
    check(bool(torch.isfinite(ys_k.float()).all()), "K1 bf16 output not finite")
    check(errbf <= 1e-2, f"K1 bf16 error {errbf} > 1e-2")
    check(same >= 0.9998, f"K1 bf16 equals the twin on {same:.6f} of its "
          "outputs, under 0.9998: its products lose the f32 contract")

    ms_k = cuda_ms(lambda: cuda_lstm.bilstm_recurrence_cuda(xw, w))
    ms_p = cuda_ms(lambda: cuda_lstm.bilstm_recurrence_plain(xw, w), reps=5)
    log(f"K1 recurrence bf16 serving shape: kernel {ms_k:.3f} ms, plain twin "
        f"{ms_p:.3f} ms (CUDA events, median) [{state['card']}]")
    # latency-bound serving: the same recurrence at batch 1 and 8
    small = {}
    for b in (1, 8):
        xs, ws = xw[:, :, :b].contiguous(), w
        e = (cuda_lstm.bilstm_recurrence_cuda(xs, ws).float()
             - cuda_lstm.bilstm_recurrence_plain(xs, ws).float()).abs().max()
        check(e.item() <= 1e-2, f"K1 bf16 B={b} error {e.item()} > 1e-2")
        small[b] = cuda_ms(lambda: cuda_lstm.bilstm_recurrence_cuda(xs, ws))
    log(f"K1 recurrence bf16 T={T} D={D} H={H}: B=1 {small[1]:.3f} ms, B=8 "
        f"{small[8]:.3f} ms, B=64 {ms_k:.3f} ms (CUDA events, median) "
        f"[{state['card']}]")
    _one_kernel_per_call("K1",
                         lambda: cuda_lstm.bilstm_recurrence_cuda(xw, w))

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
    # K1's route: three exact bf16 products per step on the tensor cores;
    # beside it the bound of the same products as f32 CUDA-core FMAs
    nbytes, flops = lstm_bytes_flops(T, D, B, H, 2)
    bms, by = bound(3 * flops, nbytes, PEAK_BF16_FLOPS)
    bms32, _ = bound(flops, nbytes)
    log(f"K1 bound at the serving shape: {bms:.3f} ms ({by}: 3 x "
        f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16, {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s); K1 at {100 * bms / ms_k:.1f} % of it. As f32 "
        f"CUDA-core FMAs (67 TFLOP/s): {bms32:.3f} ms, K1 at "
        f"{100 * bms32 / ms_k:.1f} % of that")
    state["kernels"]["bilstm_fwd"].update(
        max_abs_err=max(err32, errbf), ms=ms_k, plain_ms=ms_p, bound_ms=bms,
        bound_by=by, library_ms=ms_cudnn)
    phase_kernel_train(state, g)


def _one_kernel_per_call(name, fn):
    """fn() runs exactly one kernel on the card, by the profiler: no launch
    per step, and nothing else (memsets aside).

    The profiler can lose kernel records (seen on the H100: 2 of 3 launches
    recorded, and late in a long process 0, while the launch counters had
    all 3), so a session that records fewer kernels than calls is
    repeated, up to 3 sessions; one that records more fails at once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.2)     # the last records reach the profiler late
        kernels = {e.key[:60]: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memset", "Memcpy"))}
        n = sum(kernels.values())
        log(f"{name} profile: {n} kernels in 3 calls: {kernels}")
        check(n <= 3, f"{name} ran {n} kernels in 3 calls, not one per call")
        if n == 3:
            return
    check(False, f"{name}: 3 profiler sessions recorded fewer kernels than "
          "calls")


def _one_k1_per_call_fresh(name, T, D, B, H):
    """_one_kernel_per_call on K1 at [T, D, B, H] bf16, in a fresh process:
    after the serving phases the profiler recorded 0 of 3 K1 launches (on
    the H100)."""
    code = "\n".join([
        "import sys, torch",
        f"sys.path.insert(0, {REPO!r})",
        "import chip_smoke",
        "from horizonnet_tpu_torch.ops import cuda_lstm",
        f"xw = torch.randn({T}, {D}, {B}, {4 * H}, device='cuda')"
        ".to(torch.bfloat16)",
        f"w = ((torch.rand({D}, {H}, {4 * H}, device='cuda') * 2 - 1) "
        f"* {H ** -0.5}).to(torch.bfloat16)",
        f"chip_smoke._one_kernel_per_call({name!r}, "
        "lambda: cuda_lstm.bilstm_recurrence(xw, w))"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        log(line)
    check(proc.returncode == 0, f"{name}: {proc.stderr[-3000:]}")


def phase_kernel_train(state, g):
    import torch
    from horizonnet_tpu_torch.ops import cuda_lstm, cuda_lstm_train as clt
    from horizonnet_tpu_torch.ops.lstm import bidir_layer

    dev = torch.device("cuda")

    def inputs(T, D, B, H, dtype):
        xw = torch.randn(T, D, B, 4 * H, generator=g)
        w = (torch.rand(D, H, 4 * H, generator=g) * 2 - 1) * H ** -0.5
        dys = torch.randn(T, D, B, H, generator=g)
        return [t.to(dev, dtype) for t in (xw, w, dys)]

    err2 = err3 = 0.0
    for (T, D, B, H), dtype, tol in (((16, 2, 3, 32), torch.float32, 1e-5),
                                     ((256, 2, 8, 512), torch.bfloat16,
                                      1e-2)):
        xw, w, dys = inputs(T, D, B, H, dtype)
        fwd_k = clt.train_fwd_cuda(xw, w)
        fwd_p = clt.train_fwd_plain(xw, w)
        e2 = [rel_err(a, b) for a, b in zip(fwd_k, fwd_p)]
        ys, gates, cs = fwd_p
        dxw_k = clt.train_bwd_cuda(gates, cs, dys, w)
        dxw_p = clt.train_bwd_plain(gates, cs, dys, w)
        e3 = [rel_err(dxw_k, dxw_p),
              rel_err(clt.weight_grad(ys, dxw_k, w),
                      clt.weight_grad(ys, dxw_p, w))]
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        log(f"K2 {name} [T={T},D={D},B={B},H={H}] (ys, gates, cs) "
            f"relative {[f'{r:.2e}' for r, _ in e2]}, abs "
            f"{[f'{a:.2e}' for _, a in e2]}; K3 (dxw, dW) relative "
            f"{[f'{r:.2e}' for r, _ in e3]}, abs {[f'{a:.2e}' for _, a in e3]}"
            f" (tol {tol:g} relative)")
        check(all(r <= tol for r, _ in e2), f"K2 {name} error {e2} > {tol}")
        check(all(r <= tol for r, _ in e3), f"K3 {name} error {e3} > {tol}")
        err2 = max(err2, *(a for _, a in e2))
        err3 = max(err3, *(a for _, a in e3))
        if dtype == torch.bfloat16:
            # the 1e-2 bar sees only the output rounding; bit equality with
            # the twin is what shows the three-term products keep the f32
            # contract (bars from horizonnet_tpu_torch/tools/split_check.py)
            same2 = [(a == b).float().mean().item()
                     for a, b in zip(fwd_k, fwd_p)]
            same3 = (dxw_k == dxw_p).float().mean().item()
            log(f"K2 bf16 training shape: (ys, gates, cs) "
                f"{[f'{100 * v:.4f}' for v in same2]} % equal to the twin's "
                f"bit for bit (at least {100 * K2_SAME_BAR:g} %); K3 dxw "
                f"{100 * same3:.4f} % (at least {100 * K3_SAME_BAR:g} %)")
            check(min(same2) >= K2_SAME_BAR, f"K2 bf16 equals the twin on "
                  f"{same2} of its outputs: its products lose the f32 "
                  "contract")
            check(same3 >= K3_SAME_BAR, f"K3 bf16 equals the twin on "
                  f"{same3} of its outputs: its products lose the f32 "
                  "contract")
            _one_kernel_per_call("K2", lambda: clt.train_fwd_cuda(xw, w))
            _one_kernel_per_call("K3", lambda: clt.train_bwd_cuda(
                gates, cs, dys, w))

    # the autograd.Function against torch.autograd through the plain loop
    xw, w, dys = inputs(256, 2, 8, 512, torch.float32)
    grads = []
    for fn in (clt.bilstm_recurrence_trainable,
               cuda_lstm.bilstm_recurrence_plain):
        a, b = xw.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(a, b) * dys).sum().backward()
        grads.append((a.grad, b.grad))
    eg = [rel_err(x, y) for x, y in zip(*grads)]
    log(f"autograd.Function f32 [T=256,D=2,B=8,H=512] grads (xw, w_hh_t) vs "
        f"autograd through the plain loop: relative "
        f"{[f'{r:.2e}' for r, _ in eg]} (tol 1e-4)")
    check(all(r <= 1e-4 for r, _ in eg), f"Function grads off: {eg}")

    T, D, B, H, I = 256, 2, 8, 512, 1024
    xw, w, dys = inputs(T, D, 64, H, torch.bfloat16)
    ms2b, ms3b = {}, {}
    for b in (1, 8, 64):
        xs, ds = xw[:, :, :b].contiguous(), dys[:, :, :b].contiguous()
        _, gates, cs = clt.train_fwd_cuda(xs, w)
        ms2b[b] = cuda_ms(lambda: clt.train_fwd_cuda(xs, w))
        ms3b[b] = cuda_ms(lambda: clt.train_bwd_cuda(gates, cs, ds, w))
    xw, dys = xw[:, :, :B].contiguous(), dys[:, :, :B].contiguous()
    ys, gates, cs = clt.train_fwd_cuda(xw, w)
    ms2, ms3 = ms2b[B], ms3b[B]
    # host time to enqueue one call, 20 calls queued without a sync: the
    # train step's host-dispatch layer (a launch that waited for the card
    # would take the kernel's time here)
    host = []
    for fn in (lambda: clt.train_fwd_cuda(xw, w),
               lambda: clt.train_bwd_cuda(gates, cs, dys, w)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host.append((time.perf_counter() - t0) / 20 * 1e3)
        torch.cuda.synchronize()
    ms2p = cuda_ms(lambda: clt.train_fwd_plain(xw, w), reps=3)
    ms3p = cuda_ms(lambda: clt.train_bwd_plain(gates, cs, dys, w), reps=3)

    # cuDNN's nn.LSTM on one bidirectional layer at the training shape,
    # bf16, the same weights: the comparator for K2 (forward with grad),
    # K3 (backward alone) and the port's layer (projection + K2 + K3 + dW)
    x = torch.randn(T, B, I, generator=g).to(dev, torch.bfloat16)
    k = H ** -0.5
    p = {"w_ih": ((torch.rand(D, 4 * H, I, generator=g) * 2 - 1) * k),
         "w_hh": ((torch.rand(D, 4 * H, H, generator=g) * 2 - 1) * k),
         "b": ((torch.rand(D, 4 * H, generator=g) * 2 - 1) * k)}
    p = {n: v.to(dev).requires_grad_() for n, v in p.items()}
    ref = torch.nn.LSTM(I, H, num_layers=1, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(ref, "weight_ih_l0" + sfx).copy_(p["w_ih"][d])
            getattr(ref, "weight_hh_l0" + sfx).copy_(p["w_hh"][d])
            getattr(ref, "bias_ih_l0" + sfx).copy_(p["b"][d])
            getattr(ref, "bias_hh_l0" + sfx).zero_()
    ref = ref.to(torch.bfloat16)
    xg = x.clone().requires_grad_()
    dy = torch.randn(T, B, 2 * H, generator=g).to(dev, torch.bfloat16)
    y_ref = ref(xg)[0]
    y_port = bidir_layer(xg, p, "kernel_train")
    diff = (y_port.float() - y_ref.float()).abs().max().item()
    ref_params = list(ref.parameters())
    ms_cudnn_f = cuda_ms(lambda: ref(xg))
    ms_cudnn_b = cuda_ms(lambda: torch.autograd.grad(
        y_ref, [xg, *ref_params], dy, retain_graph=True))
    ms_cudnn_fb = cuda_ms(lambda: torch.autograd.grad(
        ref(xg)[0], [xg, *ref_params], dy))
    ms_port_fb = cuda_ms(lambda: torch.autograd.grad(
        bidir_layer(xg, p, "kernel_train"), [xg, *p.values()], dy))
    card = state["card"]
    log(f"K2 bf16 [T={T},D={D},B={B},H={H}]: kernel {ms2:.3f} ms, plain twin "
        f"{ms2p:.3f} ms; K3: kernel {ms3:.3f} ms, plain twin {ms3p:.3f} ms "
        f"(CUDA events, median) [{card}]")
    log(f"K2/K3 bf16 T={T} D={D} H={H} by batch: K2 B=1 {ms2b[1]:.3f}, B=8 "
        f"{ms2b[8]:.3f}, B=64 {ms2b[64]:.3f} ms; K3 B=1 {ms3b[1]:.3f}, B=8 "
        f"{ms3b[8]:.3f}, B=64 {ms3b[64]:.3f} ms (CUDA events, median) "
        f"[{card}]")
    log(f"K2/K3 host time per call at B={B} (20 calls queued, no sync): K2 "
        f"{host[0]:.3f} ms, K3 {host[1]:.3f} ms")
    log(f"bi-LSTM layer bf16 [T={T},B={B},I={I},H={H}] forward + backward: "
        f"port (projection + K2 + K3 + dW, f32 master weights) "
        f"{ms_port_fb:.3f} ms; cuDNN nn.LSTM {ms_cudnn_fb:.3f} ms (forward "
        f"{ms_cudnn_f:.3f}, backward {ms_cudnn_b:.3f}); max|port - cuDNN| "
        f"forward {diff:.3e} [{card}]")
    for name, ms, mp, lib, err, bwd in (
            ("bilstm_train_fwd", ms2, ms2p, ms_cudnn_f, err2, False),
            ("bilstm_bwd", ms3, ms3p, ms_cudnn_b, err3, True)):
        # the kernels' route: three exact bf16 products on the tensor cores;
        # beside it the bound of the same products as f32 CUDA-core FMAs
        nbytes, flops = lstm_bytes_flops(T, D, B, H, 2, residuals=True,
                                         backward=bwd)
        bms, by = bound(3 * flops, nbytes, PEAK_BF16_FLOPS)
        bms32, by32 = bound(flops, nbytes)
        log(f"{name} bound: {bms:.3f} ms ({by}: 3 x {flops / 1e9:.2f} GFLOP "
            f"at 989 TFLOP/s bf16, {nbytes / 1e6:.1f} MB at 3.35 TB/s); "
            f"kernel at {100 * bms / ms:.1f} % of it. As f32 CUDA-core FMAs "
            f"(67 TFLOP/s): {bms32:.3f} ms ({by32}), kernel at "
            f"{100 * bms32 / ms:.1f} % of that")
        state["kernels"][name].update(max_abs_err=err, ms=ms, plain_ms=mp,
                                      bound_ms=bms, bound_by=by,
                                      library_ms=lib)
    phase_kernel_fused(state, g)


def _bottleneck(C, dtype, g):
    """The port's Bottleneck (C channels, width C/4) on the card in eval,
    channels_last, with randomized batch norm (a fresh one is the
    identity and would hide a wrong fold), and K4's folded inputs."""
    import torch
    from horizonnet_tpu_torch.models.resnet import Bottleneck
    from horizonnet_tpu_torch.ops.fused_block import fold_conv_bn

    blk = Bottleneck(C, C // 4)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0, m.weight[0].numel() ** -0.5, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.5, generator=g)
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    blk = blk.cuda().eval()
    for m in blk.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(dtype)
    blk = blk.to(memory_format=torch.channels_last)
    folded = []
    for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2[1], blk.bn2),
                     (blk.conv3, blk.bn3)):
        folded += fold_conv_bn(conv.weight.permute(2, 3, 1, 0), bn.weight,
                               bn.bias, bn.running_mean, bn.running_var,
                               bn.eps)
    w1, b1, w2, b2, w3, b3 = folded
    return blk, (w1[0, 0], b1, w2, b2, w3[0, 0], b3)


def phase_kernel_fused(state, g):
    import torch
    from horizonnet_tpu_torch.ops import fused_block as fb

    card = state["card"]
    err = 0.0
    # f32 at tests/test_pallas_block.py's shapes: 2e-5 relative
    for B, H, W, C in ((2, 16, 32, 64), (1, 64, 32, 64), (2, 32, 16, 256),
                       (1, 16, 8, 2048)):
        _, wts = _bottleneck(C, torch.float32, g)
        x = torch.randn(B, H, W, C, generator=g).cuda()
        r, a = rel_err(fb.fused_bottleneck_cuda(x, *wts),
                       fb.fused_bottleneck_plain(x, *wts))
        torch.cuda.synchronize()
        log(f"K4 f32 [B={B},H={H},W={W},C={C}] relative {r:.2e}, abs "
            f"{a:.2e} (tol 2e-5 relative)")
        check(r <= 2e-5, f"K4 f32 error {r} > 2e-5 at {(B, H, W, C)}")
        err = max(err, a)

    # bf16 at the tile plans' edges: W narrower than the tile, H and W not
    # multiples of it, grids that are not a multiple of the cluster, and
    # each resnet50 width at a small batch; 3e-2 relative
    worst = 0.0
    for B, H, W, C in ((2, 16, 8, 256), (1, 17, 23, 256), (1, 9, 40, 1024),
                       (1, 7, 24, 2048), (2, 12, 32, 256), (2, 12, 32, 512),
                       (2, 12, 32, 1024), (2, 12, 32, 2048)):
        _, wts = _bottleneck(C, torch.bfloat16, g)
        x = torch.randn(B, H, W, C, generator=g).to("cuda", torch.bfloat16)
        r, a = rel_err(fb.fused_bottleneck_cuda(x, *wts),
                       fb.fused_bottleneck_plain(x, *wts))
        torch.cuda.synchronize()
        check(r <= 3e-2, f"K4 bf16 error {r} > 3e-2 at {(B, H, W, C)}")
        worst = max(worst, r)
        err = max(err, a)
    log(f"K4 bf16 at 8 edge shapes (tile plans 64-512, ragged tiles, cluster "
        f"remainders): worst relative {worst:.2e} (tol 3e-2)")

    # bf16 at the resnet50 stage shapes, B=64: 3e-2 relative; timed
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    t_ops = t_bytes = 0.0
    for (B, H, W, C), n in zip(STAGES, RESNET50_IDENTITY):
        Wd = C // 4
        blk, wts = _bottleneck(C, torch.bfloat16, g)
        x = torch.randn(B, C, H, W, generator=g).to(
            "cuda", torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
        xh = x.permute(0, 2, 3, 1)                 # NHWC, no copy
        with torch.no_grad():
            y = fb.fused_bottleneck_cuda(xh, *wts)
            r, a = rel_err(y, fb.fused_bottleneck_plain(xh, *wts))
            lib_diff = rel_err(y.permute(0, 3, 1, 2), blk(x))[0]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y.float()).all()),
                  f"K4 bf16 output not finite at {(B, H, W, C)}")
            ms = cuda_ms(lambda: fb.fused_bottleneck_cuda(xh, *wts))
            mp = cuda_ms(lambda: fb.fused_bottleneck_plain(xh, *wts), reps=3)
            ml = cuda_ms(lambda: blk(x))
        flops = 34.0 * Wd * Wd * B * H * W
        nbytes = 2.0 * B * H * W * C * 2 + 17 * Wd * Wd * 2 + (2 * Wd + C) * 4
        bms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        log(f"K4 bf16 [B={B},H={H},W={W},C={C}]: relative {r:.2e}, abs "
            f"{a:.2e} (tol 3e-2 relative); kernel {ms:.3f} ms, plain twin "
            f"{mp:.3f} ms, unfused Bottleneck (cuDNN + ATen) {ml:.3f} ms "
            f"(relative difference {lib_diff:.2e}); bound {bms:.3f} ms ({by}:"
            f" {flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16, "
            f"{nbytes / 1e6:.1f} MB at 3.35 TB/s), kernel at "
            f"{100 * bms / ms:.1f} % of it; weights read from L2 "
            f"{fb.weight_bytes(B, H, W, Wd) / 1e9:.3f} GB per launch [{card}]")
        check(r <= 3e-2, f"K4 bf16 error {r} > 3e-2 at {(B, H, W, C)}")
        err = max(err, a)
        for k, v in (("ms", ms), ("plain_ms", mp), ("bound_ms", bms),
                     ("library_ms", ml)):
            tot[k] += n * v
        t_ops += n * flops / PEAK_BF16_FLOPS
        t_bytes += n * nbytes / PEAK_BYTES
    log(f"K4 over the 12 identity blocks of one resnet50 forward (B=64, bf16)"
        f": kernel {tot['ms']:.3f} ms, plain twin {tot['plain_ms']:.3f} ms, "
        f"unfused Bottlenecks {tot['library_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.3f} ms [{card}]")
    state["kernels"]["fused_bottleneck"].update(
        max_abs_err=err, bound_by="operations" if t_ops >= t_bytes
        else "bytes", **tot)


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


def _flagship_wire(state, B=FLAGSHIP_B, n_distinct=3):
    """n_distinct dct4 batches of B copies of val_room, rolled per sample
    (seed 0); packed once per run."""
    import numpy as np
    from horizonnet_tpu_torch.ops.dct import pack_dct4

    if "wire" not in state:
        img, _ = _golden_inputs()
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        wire = []
        for _ in range(n_distinct):
            rolls = rng.integers(0, img.shape[1], B)
            wire.append(pack_dct4(np.stack([np.roll(img, r, axis=1)
                                            for r in rolls])))
        log(f"packed {n_distinct} dct4 batches of {B} in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({wire[0].nbytes / B / 1024:.1f} KiB/pano)")
        state["wire"] = wire
    return state["wire"]


def _flagship_engine(postproc, fused_blocks="", backbone="resnet50",
                     quant_int8=False, batch_size=FLAGSHIP_B):
    """resnet50_rnn (or ``backbone``), bf16, the flagship batch (or
    ``batch_size``), dct4 wire, random weights (seed 0); ``quant_int8``:
    the int8 encoder on the same float weights folded by
    models/quant.py::quantize_state_dict."""
    import torch
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.models.quant import quantize_state_dict

    kw = dict(device="cuda", dtype=torch.bfloat16, lstm_impl="kernel")
    model = build_model(backbone, True, seed=0, fused_blocks=fused_blocks,
                        **kw)
    sd = model.state_dict()
    if quant_int8:
        sd = quantize_state_dict(sd)
        model = build_model(backbone, True, quant_int8=True, **kw)
    return InferenceEngine(model, sd, batch_size=batch_size,
                           postproc=postproc, input_format="dct4",
                           device="cuda")


def _serve(eng, feed, finish, workers=1):
    """serve_stream at depth 3 over feed: (panos/s, results)."""
    from horizonnet_tpu_torch.inference import serve_stream

    t0 = time.perf_counter()
    results = list(serve_stream(eng, iter(feed), depth=3, finish=finish,
                                workers=workers))
    return len(feed) * FLAGSHIP_B / (time.perf_counter() - t0), results


def _device_rate(eng, xs, n_batches):
    """Panos/s of the engine's program on batches already on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_batches):
        eng.run(xs[i % len(xs)])
    torch.cuda.synchronize()
    return n_batches * FLAGSHIP_B / (time.perf_counter() - t0)


def phase_flagship(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs

    B, n_batches, reps = FLAGSHIP_B, 12, 3
    wire = _flagship_wire(state)
    eng = _flagship_engine("cuboid")

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(cid.shape == (B, 8, 2) and z1.shape == (B,),
              f"flagship result shapes {cid.shape} {z1.shape}")
        check(bool(np.isfinite(cid).all() and np.isfinite(z1).all()),
              "flagship result not finite")
        return cid

    t0 = time.perf_counter()
    _serve(eng, wire, finish)
    torch.cuda.synchronize()
    log(f"flagship warm-up ({len(wire)} batches): "
        f"{time.perf_counter() - t0:.1f} s")

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    serving = []
    cuda_lstm.launches = 0
    for _ in range(reps):
        rate, results = _serve(eng, feed, finish)
        check(len(results) == n_batches, "serve_stream lost batches")
        serving.append(rate)
    launches = cuda_lstm.launches
    _launched(state, "bilstm_fwd", "flagship", launches)

    xs = [eng.put(w) for w in wire]
    device = [_device_rate(eng, xs, n_batches) for _ in range(reps)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"flagship resnet50_rnn bf16 B={B} dct4 cuboid: serving "
        f"{statistics.median(serving):.1f} panos/s (median of {reps} runs "
        f"of {n_batches} batches, depth 3; runs "
        f"{[round(v, 1) for v in serving]}), device-resident "
        f"{statistics.median(device):.1f} panos/s (runs "
        f"{[round(v, 1) for v in device]}), peak memory {peak:.1f} GiB, "
        f"K1 launches {launches} [{state['card']}]")


def phase_fused(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.ops import fused_block
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs

    card = state["card"]
    n_batches, reps = 12, 2
    wire = _flagship_wire(state)
    engs = {"unfused": _flagship_engine("cuboid"),
            "fused": _flagship_engine("cuboid", fused_blocks="kernel")}
    xs = [engs["fused"].put(w) for w in wire]

    # one forward = 12 K4 launches; the corner drift on the first batch
    with torch.no_grad():
        cid = {}
        for name, eng in engs.items():
            fused_block.launches = 0
            cid[name] = unpack_cuboid_outputs(eng.run(xs[0]))[0]
            torch.cuda.synchronize()
            if name == "fused":
                check(fused_block.launches == 12, f"K4 launched "
                      f"{fused_block.launches} times in one forward, not 12")
            else:
                check(fused_block.launches == 0, "the unfused model ran K4")
    drift = np.abs(cid["fused"] - cid["unfused"]) * np.array([1024, 512])
    log(f"fused vs unfused flagship, first batch (bf16, random weights): "
        f"max corner drift {drift.max():.3f} px, median "
        f"{np.median(drift):.3f} px")
    check(bool(np.isfinite(cid["fused"]).all()), "fused corners not finite")

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(bool(np.isfinite(cid).all() and np.isfinite(z1).all()),
              "fused flagship result not finite")
        return cid

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    for eng in engs.values():                              # warm-up
        _serve(eng, wire, finish)
    serving = {k: [] for k in engs}
    device = {k: [] for k in engs}
    fused_block.launches = 0
    for name in ("unfused", "fused", "fused", "unfused") * reps:
        serving[name].append(_serve(engs[name], feed, finish)[0])
    launches = fused_block.launches
    for name in ("unfused", "fused", "fused", "unfused") * reps:
        device[name].append(_device_rate(engs[name], xs, n_batches))
    forwards = 2 * reps * n_batches
    check(launches == 12 * forwards, f"K4 launches {launches} on "
          f"{forwards} fused forwards, not 12 each")
    _launched(state, "fused_bottleneck", "fused flagship", launches)
    med = {k: statistics.median(v) for k, v in serving.items()}
    dmed = {k: statistics.median(v) for k, v in device.items()}
    log(f"flagship resnet50_rnn bf16 B=64 dct4 cuboid, in turns (unfused, "
        f"fused, fused, unfused) x {reps}: serving unfused "
        f"{med['unfused']:.1f}, fused {med['fused']:.1f} panos/s (runs "
        f"{[round(v, 1) for v in serving['unfused']]} / "
        f"{[round(v, 1) for v in serving['fused']]}); device unfused "
        f"{dmed['unfused']:.1f}, fused {dmed['fused']:.1f} panos/s (runs "
        f"{[round(v, 1) for v in device['unfused']]} / "
        f"{[round(v, 1) for v in device['fused']]}); K4 launches {launches} "
        f"({forwards} forwards) [{card}]")
    del engs, xs
    torch.cuda.empty_cache()

    # f32, B=1 at 512x1024, randomized batch norm, TF32 off: the
    # model-level proof (the golden checkpoint is resnet18, no bottlenecks)
    g = torch.Generator(device="cpu").manual_seed(1)
    models = [build_model("resnet50", True, device="cuda", seed=0,
                          fused_blocks=f) for f in ("", "kernel")]
    _randomize_bn(models[0], g)
    with torch.no_grad():
        models[1].load_state_dict(models[0].state_dict())
        x = torch.rand(1, 3, 512, 1024, generator=g).cuda()
        fused_block.launches = 0
        (bu, cu), (bf, cf) = (m(x) for m in models)
        torch.cuda.synchronize()
    db = (bf - bu).abs().max().item()
    dc = (cf - cu).abs().max().item()
    log(f"fused vs unfused resnet50_rnn f32 B=1 512x1024 (randomized batch "
        f"norm, TF32 off): max|bon| diff {db:.2e}, max|cor| diff {dc:.2e} "
        f"(tol 2e-4), K4 launches {fused_block.launches}")
    check(fused_block.launches == 12, "the f32 fused model did not run K4 "
          "12 times")
    check(db <= 2e-4 and dc <= 2e-4, f"fused f32 model off: {db}, {dc}")


def phase_general(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.ops.yuv import pack_yuv420
    from horizonnet_tpu_torch.postproc import finish_general_batch
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    card = state["card"]
    img, want = _golden_inputs()
    model, sd = load_trained_model(
        os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt"), device="cuda")
    for fmt, x in (("float", img[None].astype(np.float32) / 255.0),
                   ("yuv420", pack_yuv420(img[None]))):
        eng = InferenceEngine(model, sd, postproc="general",
                              input_format=fmt, device="cuda")
        (cor_id, z0, z1), = finish_general_batch(eng(x))
        n = len(cor_id)
        check(cor_id.shape == want["general_uv"].shape,
              f"golden general ({fmt}): {n} corners, not 12")
        dpx = float(np.abs(cor_id - want["general_uv"]).max() * 512)
        dz1 = abs(z1 - float(want["general_z1"]))
        log(f"golden general f32 ({fmt} wire, TF32 off): {n} corners, "
            f"{dpx:.4f} px from general_uv, |dz1| {dz1:.4f}; corners "
            f"{np.round(cor_id, 4).tolist()}")
        check(dpx < 2.0, f"golden general ({fmt}) corners off by {dpx} px")
        if fmt == "float":
            check(dz1 < 0.2, f"golden general z1 off by {dz1}")

    n_batches, reps = 12, 2
    wire = _flagship_wire(state)
    engs = {"general": _flagship_engine("general"),
            "cuboid": _flagship_engine("cuboid")}

    def finish(outs):
        res = finish_general_batch(outs)
        check(len(res) == FLAGSHIP_B and all(
            np.isfinite(c).all() and np.isfinite(z1) for c, _, z1 in res),
            "general result not finite")
        return res

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    _serve(engs["general"], wire, finish, 4)                  # warm-up
    serving = [_serve(engs["general"], feed, finish, 4)[0]
               for _ in range(reps)]
    xs = [engs["general"].put(w) for w in wire]
    device = {k: [] for k in engs}
    for name in ("general", "cuboid", "cuboid", "general") * reps:
        device[name].append(_device_rate(engs[name], xs, n_batches))
    outs = engs["general"].run(xs[0])
    t0 = time.perf_counter()
    finish(outs)
    t_tail = time.perf_counter() - t0
    dmed = {k: statistics.median(v) for k, v in device.items()}
    log(f"general resnet50_rnn bf16 B=64 dct4, serve_stream depth 3 with "
        f"finish_general_batch on 4 workers: serving "
        f"{statistics.median(serving):.1f} panos/s (runs "
        f"{[round(v, 1) for v in serving]}); device general "
        f"{dmed['general']:.1f}, cuboid {dmed['cuboid']:.1f} panos/s in "
        f"turns (runs {[round(v, 1) for v in device['general']]} / "
        f"{[round(v, 1) for v in device['cuboid']]}); the host tail of one "
        f"batch (fetch + finish_general_batch, one thread) "
        f"{t_tail * 1e3:.1f} ms [{card}]")


def _reference_pth(path, model, sd, infix=True, fmt="self_describing"):
    """Write ``sd`` (the port's, i.e. the reference's keys) as a reference
    .pth: bias_hh takes half of the folded LSTM bias (exact in binary, so
    folding it back gives the same bias), and with infix=False the
    wrap-padded convs lose the LR_PAD Sequential's ``.1`` infix."""
    import torch

    ref = dict(sd)
    for k in sd:
        if k.startswith("bi_rnn.bias_hh"):
            ih = "bi_rnn.bias_ih" + k[len("bi_rnn.bias_hh"):]
            ref[k] = sd[ih] * 0.5
            ref[ih] = sd[ih] - ref[k]
    if not infix:
        padded = {n for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Conv2d) and n.endswith(".1")}
        ref = {(f"{k.rsplit('.', 2)[0]}.{k.rsplit('.', 1)[1]}"
                if k.rsplit(".", 1)[0] in padded else k): v
               for k, v in ref.items()}
    kw = {"backbone": model.backbone, "use_rnn": model.use_rnn}
    if fmt == "self_describing":
        torch.save({"args": {}, "kwargs": kw, "state_dict": ref}, path)
    else:   # the training checkpoint.pth.tar, saved through DataParallel
        torch.save({"epoch": 1, "backbone": kw["backbone"],
                    "optimizer": {}, "state_dict": {
                        f"module.{k}": v for k, v in ref.items()}}, path)


def phase_host(state):
    import contextlib
    import io

    import numpy as np
    import torch
    from horizonnet_tpu_torch.cli.inference import main as cli_main
    from horizonnet_tpu_torch.inference import (InferenceEngine, inference,
                                                net_forward, postprocess)
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model
    from horizonnet_tpu_torch.viewer.visualize import visualize_a_data

    card = state["card"]
    img, want = _golden_inputs()
    ckpt = os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt")
    pano = os.path.join(GOLDEN, "val_room.png")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        def cli(name, pth, *extra):
            out = os.path.join(root, name)
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                rc = cli_main(["--pth", pth, "--img_glob", pano,
                               "--output_dir", out, "--device", "cuda",
                               *extra])
            check(rc == 0, f"host CLI {name} returned {rc}: "
                  f"{err.getvalue()[-2000:]}")
            with open(os.path.join(out, "val_room.json")) as f:
                return json.load(f), out

        # the golden through the CLI without --device_postproc, f32
        jsons = {}
        for mode, extra in (("cuboid", ["--force_cuboid"]), ("general", [])):
            got, _ = cli(mode, ckpt, *extra)
            uv, ref = np.asarray(got["uv"]), want[f"{mode}_uv"]
            check(uv.shape == ref.shape, f"host CLI {mode}: {len(uv)} "
                  f"corners, not {len(ref)}")
            dpx = float(np.abs(uv - ref).max() * 512)
            dz1 = abs(got["z1"] - float(want[f"{mode}_z1"]))
            log(f"host CLI {mode} (f32, TF32 off): corners {dpx:.4f} px "
                f"from golden_outputs.npz, |dz1| {dz1:.4f}")
            check(dpx < 2.0, f"host CLI {mode} corners off by {dpx} px")
            check(dz1 < 0.2, f"host CLI {mode} z1 off by {dz1}")
            jsons[mode] = got

        model, sd = load_trained_model(ckpt, device="cuda")
        x = img[None].astype(np.float32) / 255.0
        bon, cor = (t.cpu().numpy() for t in net_forward(model, sd, x))
        got, _ = cli("raw", ckpt, "--force_raw")
        cor_id, z0, z1 = postprocess(bon[0], cor[0, 0], force_raw=True)
        check(len(got["uv"]) == 2 * 1024, f"--force_raw gave "
              f"{len(got['uv'])} corners, not 2048")
        check(got == {"z0": z0, "z1": z1, "uv": [[float(u), float(v)]
                                                 for u, v in cor_id]},
              "--force_raw JSON differs from postprocess(force_raw=True) "
              "on the same outputs")

        (_, _, _, vis), = inference(model, sd, x, visualize=True)
        strip = visualize_a_data(x[0], bon[0], cor[0, 0])
        check(vis.shape == (33 + 512, 1024, 3) and np.array_equal(vis, strip),
              "inference(visualize=True) strip differs from "
              "visualize_a_data on the same outputs")
        try:
            from PIL import Image
        except ImportError:
            Image = None
        if Image is not None:
            _, out = cli("vis", ckpt, "--visualize", "--force_cuboid")
            png = np.asarray(Image.open(os.path.join(out, "val_room.raw.png")))
            half = np.asarray(Image.fromarray(strip).resize(
                (1024 // 2, (33 + 512) // 2), Image.LANCZOS))
            check(np.array_equal(png, half), "--visualize wrote another "
                  "strip")
        log("host CLI --force_raw: 2048 corners, JSON equal to "
            "postprocess(force_raw=True); --visualize: strip equal to "
            "visualize_a_data" + ("" if Image is not None else
                                  " (Pillow absent: the file not checked)"))

        for name, kw in (("pth", {}), ("pth_no_infix", {"infix": False}),
                         ("pth_tar", {"fmt": "train_tar"})):
            path = os.path.join(root, name + ".pth")
            _reference_pth(path, model, sd, **kw)
            got, _ = cli(name, path, "--force_cuboid")
            check(got == jsons["cuboid"], f"{name}: the reference .pth "
                  "gives another JSON than the .ckpt")
        log("reference .pth (nonzero bias_hh; with and without the .1 "
            "infix; the DataParallel training format): the .ckpt's JSON")

    # the serving path's host tail at full width: resnet50_rnn bf16, B=64
    B, reps = FLAGSHIP_B, 2
    del model, sd
    model = build_model("resnet50", True, device="cuda",
                        dtype=torch.bfloat16, lstm_impl="kernel", seed=0)
    sd = model.state_dict()
    rng = np.random.default_rng(0)
    rolls = rng.integers(0, img.shape[1], B)
    x = np.stack([np.roll(img, r, axis=1) for r in rolls]).astype(
        np.float32) / 255.0
    inference(model, sd, x[:1])                              # warm-up
    cuda_lstm.launches = 0
    forwards = 0
    results = {}
    for mode, kw in (("cuboid", {"force_cuboid": True}), ("general", {})):
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            results[mode] = inference(model, sd, x, **kw)
        forwards += 1
        log(f"host path {mode} first batch: {time.perf_counter() - t0:.2f} "
            f"s; {err.getvalue().count('Generate cuboid as fallback')} of "
            f"{B} panos fell back from an invalid general layout to a "
            "cuboid")
    launches = cuda_lstm.launches
    check(launches == 2 * forwards, f"K1 launched {launches} times in "
          f"{forwards} forwards of 2 recurrences")
    for mode, res in results.items():
        check(len(res) == B and all(
            np.isfinite(c).all() and np.isfinite(z1) and len(c) >= 8
            for c, _, z1, _ in res), f"host path {mode}: results not finite")
    eng = InferenceEngine(model, sd, batch_size=B, device="cuda")
    xd = eng.put(x)
    ms_dev = cuda_ms(lambda: eng.run(xd), reps=5)
    bon, cor = (t.cpu().numpy() for t in eng.run(xd))
    check(bool(np.isfinite(bon).all() and np.isfinite(cor).all()),
          "host path raw outputs not finite")
    _one_k1_per_call_fresh("K1 at the host path's shape", 256, 2, B, 512)
    ms_pano = {}
    with contextlib.redirect_stderr(io.StringIO()):
        for mode, kw in (("cuboid", {"force_cuboid": True}), ("general", {}),
                         ("force_raw", {"force_raw": True})):
            t0 = time.perf_counter()
            for b in range(B):
                postprocess(bon[b], cor[b, 0], **kw)
            ms_pano[mode] = (time.perf_counter() - t0) * 1e3 / B
    del eng, xd

    # end to end: the host path against the device-postproc flagship, in
    # turns on the same card
    wire = _flagship_wire(state)
    flag = _flagship_engine("cuboid")

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(bool(np.isfinite(cid).all()), "flagship result not finite")
        return cid

    _serve(flag, wire, finish)                               # warm-up
    rates = {"host cuboid": [], "host general": [], "device": []}
    for turn in ("host", "device", "device", "host") * reps:
        if turn == "device":
            rates["device"].append(_serve(flag, wire, finish)[0])
            continue
        for mode, kw in (("cuboid", {"force_cuboid": True}),
                         ("general", {})):
            with contextlib.redirect_stderr(io.StringIO()):
                t0 = time.perf_counter()
                inference(model, sd, x, **kw)
                rates[f"host {mode}"].append(B / (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in rates.items()}
    log(f"host path resnet50_rnn bf16 B={B} 512x1024 float input, random "
        f"weights: device forward {ms_dev:.3f} ms a batch (CUDA events); "
        f"host postprocess on one thread {ms_pano['cuboid']:.3f} ms a pano "
        f"cuboid, {ms_pano['general']:.3f} general, "
        f"{ms_pano['force_raw']:.3f} force_raw; end to end (upload, "
        f"forward, fetch, postprocess) {med['host cuboid']:.2f} panos/s "
        f"cuboid, {med['host general']:.2f} general (runs "
        f"{[round(v, 2) for v in rates['host cuboid']]} / "
        f"{[round(v, 2) for v in rates['host general']]}) against the "
        f"device-postproc flagship (dct4, serve_stream) "
        f"{med['device']:.1f} panos/s in turns (runs "
        f"{[round(v, 1) for v in rates['device']]}); K1 launches {launches} "
        f"in {forwards} forwards [{card}]")
    del flag
    torch.cuda.empty_cache()


def phase_dynamics(state):
    """tests/test_train_dynamics.py::_run_dynamics on the port at
    512x1024: resnet18_rnn from seed 594277, Adam at 3e-4 on the
    warmup-poly schedule, 150 steps at batch 4 over 8 batches, K2/K3."""
    import contextlib
    import io

    import numpy as np
    import torch
    from horizonnet_tpu_torch.cli.train import validate
    from horizonnet_tpu_torch.data.dataset import PanoCorBonDataset
    from horizonnet_tpu_torch.data.synth import synth_batch, synth_room
    from horizonnet_tpu_torch.evals import new_general_losses, test_general
    from horizonnet_tpu_torch.inference import InferenceEngine, postprocess
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)
    from horizonnet_tpu_torch.utils.image import write_png

    seed, B, n_batches, steps, n_val = 594277, 4, 8, 150, 8
    H, W = 512, 1024
    dev = torch.device("cuda")
    card = state["card"]
    rng = np.random.default_rng(seed)
    data = [synth_batch(rng, B, H=H, W=W) for _ in range(n_batches)]
    model = build_model("resnet18", True, device=dev, seed=seed,
                        lstm_impl="kernel_train", param_dtype=torch.float32)
    st = create_train_state(model, make_optimizer("Adam", warmup_poly_schedule(
        3e-4, max_iters=steps, warmup_iters=max(1, steps // 6))))
    eng = TrainEngine(model, st, B, H, W, device=dev)
    xs = [torch.from_numpy(d[0]).to(dev).float() / 255.0 for d in data]
    gen = torch.Generator(device=dev).manual_seed(seed)
    clt.fwd_launches = clt.bwd_launches = 0
    t0 = time.perf_counter()
    losses = []
    for it in range(steps):
        k = it % n_batches
        losses.append(eng.step(xs[k], data[k][1], data[k][2], gen)["total"])
    losses = [v.item() for v in losses]
    t_train = time.perf_counter() - t0
    k2, k3 = clt.fwd_launches, clt.bwd_launches
    check(k2 > 0 and k3 > 0, f"K2/K3 not launched in training: {k2}, {k3}")
    early, late = np.mean(losses[:20]), np.mean(losses[-20:])
    check(bool(np.isfinite(losses).all()), "dynamics losses not finite")
    check(late < 0.5 * early, f"dynamics loss did not halve: {early:.4f} "
          f"-> {late:.4f}")

    # held-out rooms as the JAX test scores them, one pano a forward
    val_rng = np.random.default_rng(seed + 1)
    rooms = [synth_room(val_rng, H=H, W=W) for _ in range(n_val)]
    cuda_lstm.launches = 0
    val_engine = InferenceEngine(model, model.state_dict(), batch_size=1,
                                 H=H, W=W, device=dev)
    ev = new_general_losses()
    for img, gt_cor in rooms:
        bon, cor = (t.cpu().numpy() for t in
                    val_engine(img[None].astype(np.float32) / 255.0))
        dt_cor_id, _, _ = postprocess(bon[0], cor[0, 0], H=H, W=W,
                                      force_raw=True)
        test_general(dt_cor_id * [1024, 512],
                     gt_cor * [1024 / W, 512 / H], 1024, 512, ev)
    iou3d = float(np.mean(ev["overall"]["3DIoU"]))
    k1 = cuda_lstm.launches
    check(k1 == 2 * n_val, f"K1 launched {k1} times in {n_val} validation "
          "forwards of 2 recurrences")

    # the same rooms through the train CLI's validate(), batched
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        os.makedirs(os.path.join(root, "img"))
        os.makedirs(os.path.join(root, "label_cor"))
        for i, (img, gt_cor) in enumerate(rooms):
            write_png(os.path.join(root, "img", f"room{i}.png"), img)
            np.savetxt(os.path.join(root, "label_cor", f"room{i}.txt"),
                       gt_cor, fmt="%.4f")
        ds = PanoCorBonDataset(root, return_cor=True)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            v = validate(InferenceEngine(model, model.state_dict(),
                                         batch_size=n_val, H=H, W=W,
                                         device=dev), ds, n_val)
    check("[WARN]" not in err.getvalue(), f"validate() took placeholder "
          f"metrics: {err.getvalue()[-1000:]}")
    log(f"dynamics resnet18_rnn f32 (TF32 off) B={B} {H}x{W}, {steps} "
        f"steps on {n_batches} batches in {t_train:.1f} s: loss "
        f"{early:.4f} -> {late:.4f} (first / last 20 steps), K2 {k2} and "
        f"K3 {k3} launches; held-out raw-polygon 3DIoU {iou3d:.4f} on "
        f"{n_val} rooms (bar {DYNAMICS_BAR}; K1 launches {k1}); validate() "
        f"on the same rooms at batch {n_val}: 3DIoU {v['3DIoU']:.4f}, "
        f"2DIoU {v['2DIoU']:.4f}, loss {v['total']:.4f} [{card}]")
    check(abs(v["3DIoU"] - iou3d) < 1e-3, f"validate() 3DIoU {v['3DIoU']} "
          f"differs from the per-room loop's {iou3d}")
    check(iou3d >= DYNAMICS_BAR, f"held-out 3DIoU {iou3d:.4f} below the bar "
          f"{DYNAMICS_BAR}")


def _write_rooms(root, n, H=512, W=1024, seed0=0):
    """n synthetic rooms (seed seed0 + i) as a PNG dataset under
    ``root``."""
    import numpy as np
    from horizonnet_tpu_torch.data.synth import synth_room
    from horizonnet_tpu_torch.utils.image import write_png

    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "label_cor"))
    for i in range(n):
        img, cor = synth_room(np.random.default_rng(seed0 + i), H, W)
        write_png(os.path.join(root, "img", f"room{i}.png"), img)
        np.savetxt(os.path.join(root, "label_cor", f"room{i}.txt"), cor,
                   fmt="%.4f")


def _train_batch(state):
    """One training batch of TRAIN_B synthetic rooms (seed 0) written as a
    PNG dataset, read, labelled and augmented on the card through the uint8
    wire, built once per run: (x, y_bon, y_cor, the raw uint8 panos on the
    card, seconds the build took)."""
    if "train_batch" not in state:
        import numpy as np
        import torch
        from horizonnet_tpu_torch.data.dataset import (PanoCorBonDataset,
                                                       make_training_batch)

        dev = torch.device("cuda")
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(REPO, "build")) as root:
            _write_rooms(root, TRAIN_B)
            ds = PanoCorBonDataset(root, flip=True, rotate=True, gamma=True,
                                   stretch=True)
            t0 = time.perf_counter()
            x, y_bon, y_cor = make_training_batch(
                ds, list(range(TRAIN_B)), np.random.default_rng(0),
                device=dev)
            torch.cuda.synchronize()
            t_batch = time.perf_counter() - t0
            raw = torch.from_numpy(np.stack([
                ds.load_raw(i)[0] for i in range(TRAIN_B)])).to(dev)
        state["train_batch"] = (x, y_bon, y_cor, raw, t_batch)
    return state["train_batch"]


def phase_train(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.data.augment import augment_images
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 loss_terms, make_optimizer)

    B, H, W, n_warm, n_steps, reps = TRAIN_B, 512, 1024, 3, 5, 4
    dev = torch.device("cuda")
    card = state["card"]
    x, y_bon, y_cor, raw, t_batch = _train_batch(state)
    args = [torch.full((B,), v, device=dev) for v in (1.3, 1.2)] + [
        torch.ones(B, dtype=torch.bool, device=dev),
        torch.arange(B, device=dev) * 100, torch.full((B,), 0.8, device=dev)]
    ms_aug = cuda_ms(lambda: augment_images(raw, *args))
    check(x.shape == (B, H, W, 3) and bool(torch.isfinite(x).all()),
          f"augmented batch {tuple(x.shape)} not finite")
    log(f"train batch: {B} PNGs read, labelled and augmented on the card in "
        f"{t_batch:.2f} s (first call); augmentation alone {ms_aug:.3f} ms "
        f"(uint8 wire, CUDA events) [{card}]")

    model = build_model("resnet50", True, device=dev, dtype=torch.bfloat16,
                        lstm_impl="kernel_train", param_dtype=torch.float32,
                        seed=0)
    st = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(1e-4, 1000)))
    eng = TrainEngine(model, st, B, H, W, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(n_warm):
        losses.append(eng.step(x, y_bon, y_cor, gen)["total"])
    torch.cuda.synchronize()
    log(f"train warm-up ({n_warm} steps): {time.perf_counter() - t0:.1f} s")

    clt.fwd_launches = clt.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    rates, step_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            losses.append(eng.step(x, y_bon, y_cor, gen)["total"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(n_steps * B / dt)
        step_ms.append(dt / n_steps * 1e3)
    k2, k3 = clt.fwd_launches, clt.bwd_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)), f"train losses not finite: {losses}")
    check(k2 > 0 and k3 > 0, f"K2/K3 not launched on the train path: "
          f"{k2}, {k3}")
    first, last = losses[0], float(np.mean(losses[-3:]))
    check(last < first, f"loss on the repeated batch did not fall: "
          f"{first} -> {last}")
    _launched(state, "bilstm_train_fwd", "train", k2)
    _launched(state, "bilstm_bwd", "train", k3)
    log(f"train resnet50_rnn bf16 (f32 params) B={B} {H}x{W} kernel_train: "
        f"{statistics.median(rates):.2f} panos/s (median of {reps} runs of "
        f"{n_steps} steps; runs {[round(v, 2) for v in rates]}), "
        f"{statistics.median(step_ms):.2f} ms/step, peak memory {peak:.2f} "
        f"GiB, K2 launches {k2}, K3 launches {k3}; loss {first:.4f} -> "
        f"{last:.4f} over {len(losses)} steps on one batch [{card}]")

    # where the time goes: CUDA events around the parts of one step
    xs = x.permute(0, 3, 1, 2)
    yb = torch.from_numpy(y_bon).to(dev)
    yc = torch.from_numpy(y_cor).to(dev)

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for q in model.parameters():
            q.grad = None
        ev[0].record()
        bon, cor = model(xs, gen)
        b, c = loss_terms(bon, cor, yb, yc)
        ev[1].record()
        (b + c).backward()
        ev[2].record()
        st.opt.step()
        ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    parts = [staged() for _ in range(5)]
    med = [statistics.median(col) for col in zip(*parts)]
    log(f"train step stages (CUDA events, median of 5): forward + loss "
        f"{med[0]:.2f} ms, backward {med[1]:.2f} ms, optimizer "
        f"{med[2]:.2f} ms [{card}]")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step(x, y_bon, y_cor, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3

    # kernels only (CPU operators carry their kernels' time too)
    rows = [(e.self_device_time_total / 1e3 / 3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(t for t, _ in rows)
    log(f"profiler, per step: device busy {busy:.2f} ms of {wall:.2f} ms "
        f"wall (idle share {100 * (1 - busy / wall):.1f} %); top kernels:")
    for t, key in rows[:12]:
        log(f"  {t:8.3f} ms  {100 * t / busy:5.1f} %  {key[:90]}")


def phase_train_cli(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.train.checkpoint import (load_trained_model,
                                                       read_checkpoint)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        _write_rooms(os.path.join(root, "train"), 2)
        _write_rooms(os.path.join(root, "valid"), 2, seed0=50)
        ckdir = os.path.join(root, "ckpt")

        def train(run_id, epochs, *extra):
            cmd = [sys.executable, "-m", "horizonnet_tpu_torch.cli.train",
                   "--id", run_id, "--ckpt", ckdir,
                   "--logs", os.path.join(root, "logs"),
                   "--train_root_dir", os.path.join(root, "train"),
                   "--valid_root_dir", os.path.join(root, "valid"),
                   "--backbone", "resnet18", "--batch_size_train", "2",
                   "--batch_size_valid", "2", "--epochs", str(epochs),
                   "--save_every", "1", "--lstm_impl", "pallas_train",
                   "--device", "cuda", *extra]
            env = dict(os.environ, PYTHONPATH=REPO)
            proc = subprocess.run(cmd, cwd=REPO, env=env,
                                  capture_output=True, text=True,
                                  timeout=600)
            check(proc.returncode == 0, f"train CLI {run_id} failed "
                  f"({proc.returncode}):\n{proc.stderr[-4000:]}")
            check("[WARN]" not in proc.stderr, f"train CLI {run_id}: "
                  f"placeholder validation metrics:\n{proc.stderr[-2000:]}")
            return read_checkpoint(os.path.join(ckdir, run_id,
                                                "checkpoint.ckpt"))

        t0 = time.perf_counter()
        head_a, pay_a = train("a", 2)
        t_a = time.perf_counter() - t0
        score = head_a["best_valid_score"]
        check(head_a["epoch"] == 2 and np.isfinite(score) and score > 0,
              f"checkpoint.ckpt after 2 epochs: epoch {head_a['epoch']}, "
              f"best {score}")
        best = sorted(f for f in os.listdir(os.path.join(ckdir, "a"))
                      if f.startswith("best_model_"))
        check(len(best) > 0, "the train CLI wrote no best_model_<e>.ckpt")
        sds = []
        for e in (1, 2):
            path = os.path.join(ckdir, "a", f"epoch_{e}.ckpt")
            check(os.path.isfile(path), f"train CLI wrote no {path}")
            model, sd = load_trained_model(path, device="cuda")
            check(all(bool(torch.isfinite(v.float()).all())
                      for v in sd.values()), f"epoch {e} weights not finite")
            sds.append(sd)
        moved = sum(not torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
        check(moved > 0, "the two epoch checkpoints are equal")

        head_b1, _ = train("b", 1)
        check(head_b1["epoch"] == 1, "the 1-epoch run's checkpoint")
        head_b, pay_b = train("b", 2, "--resume", os.path.join(ckdir, "b"))
        check(head_b["epoch"] == head_a["epoch"]
              and int(pay_b["step"]) == int(pay_a["step"]),
              f"resumed run at epoch {head_b['epoch']}, step "
              f"{int(pay_b['step'])}; unbroken at {head_a['epoch']}, "
              f"{int(pay_a['step'])}")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        else:
            yield path, np.asarray(tree, np.float64)

    # per weight tensor |a - b| / |a| (2-norms): Adam turns gradient noise
    # into steps of the learning rate, so a near-zero tensor's elementwise
    # ratio says little
    rel, worst = max((float(np.linalg.norm(a - b) / max(np.linalg.norm(a),
                                                        1e-30)), name)
                     for (name, a), (_, b) in zip(leaves(pay_a["params"]),
                                                  leaves(pay_b["params"])))
    log(f"train_cli: resnet18, 2 synthetic rooms to train and 2 (512x1024) "
        f"to validate; 2 epochs in {t_a:.1f} s with validation each epoch: "
        f"best 3DIoU {score:.4f}, {', '.join(best)} written; epoch_1.ckpt "
        f"and epoch_2.ckpt load back, {moved} of {len(sds[0])} tensors "
        f"differ; 1 epoch then --resume to epoch 2 reaches epoch "
        f"{head_b['epoch']}, step {int(pay_b['step'])} as the unbroken run; "
        f"largest relative difference of a weight tensor from the unbroken "
        f"run's {rel:.3e} ({worst}; cuDNN's backward is not "
        "bit-reproducible, no bar)")


def phase_cli(state):
    import numpy as np

    _, want = _golden_inputs()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    for mode, extra in (("cuboid", ["--force_cuboid"]), ("general", [])):
        with tempfile.TemporaryDirectory(
                dir=os.path.join(REPO, "build")) as out:
            cmd = [sys.executable, "-m",
                   "horizonnet_tpu_torch.cli.inference",
                   "--pth", os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt"),
                   "--img_glob", os.path.join(GOLDEN, "val_room.png"),
                   "--output_dir", out, "--device_postproc", *extra,
                   "--device", "cuda"]
            env = dict(os.environ, PYTHONPATH=REPO)
            proc = subprocess.run(cmd, cwd=REPO, env=env,
                                  capture_output=True, text=True,
                                  timeout=600)
            check(proc.returncode == 0, f"{mode} CLI failed "
                  f"({proc.returncode}):\n{proc.stderr[-4000:]}")
            with open(os.path.join(out, "val_room.json")) as f:
                got = json.load(f)
        uv = np.asarray(got["uv"])
        ref = want[f"{mode}_uv"]
        check(uv.shape == ref.shape, f"{mode} CLI: {len(uv)} corners, not "
              f"{len(ref)}")
        dpx = float(np.abs(uv - ref).max() * 512)
        log(f"cli {mode}: val_room.json corners {dpx:.4f} px from "
            "golden_outputs.npz")
        check(dpx < 2.0, f"{mode} CLI corners off by {dpx} px")


def _in_turns(engs, a, b, feed, xs, finish, reps):
    """Serving and device-resident panos/s of engines ``a`` and ``b`` in
    turns, (a, b, b, a) x reps: ({name: [serving]}, {name: [device]})."""
    serving, device = {a: [], b: []}, {a: [], b: []}
    for name in (a, b, b, a) * reps:
        serving[name].append(_serve(engs[name], feed, finish)[0])
    for name in (a, b, b, a) * reps:
        device[name].append(_device_rate(engs[name], xs, len(feed)))
    return serving, device


def _turns_line(serving, device):
    """'serving a x, b y panos/s (runs ...); device ...' for _in_turns."""
    def part(rates):
        med = ", ".join(f"{k} {statistics.median(v):.1f}"
                        for k, v in rates.items())
        runs = " / ".join(str([round(x, 1) for x in v])
                          for v in rates.values())
        return f"{med} panos/s (runs {runs})"
    return f"serving {part(serving)}; device {part(device)}"


def _top_kernels(name, fn, n=2, top=8):
    """Log the device time of fn() by kernel under the profiler (mean of n
    calls): device busy ms and the ``top`` largest kernels. Informational:
    the profiler can lose records (see _one_kernel_per_call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(t for t, _ in rows)
    log(f"{name}: profiler device busy {busy:.2f} ms a call; top kernels:")
    for t, key in rows[:top]:
        log(f"  {t:8.3f} ms  {100 * t / busy:5.1f} %  {key[:90]}")


def phase_densenet(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.models.registry import ENCODER_DENSENET
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)

    card = state["card"]
    B, n_batches, reps = FLAGSHIP_B, 12, 2
    wire = _flagship_wire(state)
    engs = {"densenet121": _flagship_engine("cuboid", backbone="densenet121"),
            "resnet50": _flagship_engine("cuboid")}
    xs = [engs["resnet50"].put(w) for w in wire]

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(cid.shape == (B, 8, 2) and bool(
            np.isfinite(cid).all() and np.isfinite(z1).all()),
            f"densenet121 serving result {cid.shape} not finite")
        return cid

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    for eng in engs.values():                               # warm-up
        _serve(eng, wire, finish)
    cuda_lstm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _serve(engs["densenet121"], feed, finish)
    k1 = cuda_lstm.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(k1 == 2 * n_batches, f"K1 launched {k1} times in {n_batches} "
          "densenet121 forwards of 2 recurrences")
    _launched(state, "bilstm_fwd", "densenet121 serving", k1)
    serving, device = _in_turns(engs, "densenet121", "resnet50", feed, xs,
                                finish, reps)
    log(f"densenet121_rnn bf16 B={B} dct4 cuboid against the resnet50 "
        f"flagship, in turns (densenet121, resnet50, resnet50, densenet121) "
        f"x {reps}: {_turns_line(serving, device)}; densenet121 peak memory "
        f"{peak:.1f} GiB, K1 launches {k1} in {n_batches} forwards [{card}]")
    _top_kernels(f"densenet121 serving, one B={B} batch",
                 lambda: engs["densenet121"].run(xs[0]))
    del engs, xs
    torch.cuda.empty_cache()

    # each densenet, f32 at B=1 with randomized batch norm, TF32 off: the
    # card against the same model's forward on the CPU
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.rand(1, 3, 512, 1024, generator=g)
    for bb in ENCODER_DENSENET:
        cpu = build_model(bb, True, device="cpu", seed=0)
        _randomize_bn(cpu, g)
        gpu = build_model(bb, True, device="cuda", lstm_impl="kernel")
        gpu.load_state_dict(cpu.state_dict())
        cuda_lstm.launches = 0
        with torch.no_grad():
            want = cpu(x)
            got = gpu(x.cuda())
            torch.cuda.synchronize()
        (rb, db), (rc, dc) = (rel_err(a.cpu(), w) for a, w in zip(got, want))
        log(f"{bb}_rnn f32 B=1 512x1024 (randomized batch norm, TF32 off), "
            f"card against CPU: bon {db:.2e} ({rb:.2e} relative), cor "
            f"{dc:.2e} ({rc:.2e}) (tol 2e-4 relative to max(1, |cpu|)); K1 "
            f"launches {cuda_lstm.launches}")
        check(cuda_lstm.launches == 2, f"{bb}: K1 was not launched twice")
        check(max(rb, rc) <= 2e-4, f"{bb} card off the CPU: {rb}, {rc}")
        del cpu, gpu

    # training: densenet121 at the train phase's configuration
    n_warm, n_steps = 3, 10
    dev = torch.device("cuda")
    x, y_bon, y_cor, _, _ = _train_batch(state)
    model = build_model("densenet121", True, device=dev, dtype=torch.bfloat16,
                        lstm_impl="kernel_train", param_dtype=torch.float32,
                        seed=0)
    st = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(1e-4, 1000)))
    eng = TrainEngine(model, st, TRAIN_B, 512, 1024, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = [eng.step(x, y_bon, y_cor, gen)["total"] for _ in range(n_warm)]
    torch.cuda.synchronize()
    clt.fwd_launches = clt.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        losses.append(eng.step(x, y_bon, y_cor, gen)["total"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k2, k3 = clt.fwd_launches, clt.bwd_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)), f"densenet121 losses not finite: "
          f"{losses}")
    first, last = losses[0], float(np.mean(losses[-3:]))
    check(last < first, f"densenet121 loss on the repeated batch did not "
          f"fall: {first} -> {last}")
    _launched(state, "bilstm_train_fwd", "densenet121 train", k2)
    _launched(state, "bilstm_bwd", "densenet121 train", k3)
    log(f"train densenet121_rnn bf16 (f32 params) B={TRAIN_B} 512x1024 "
        f"kernel_train, Adam: {n_steps * TRAIN_B / dt:.2f} panos/s, "
        f"{dt / n_steps * 1e3:.2f} ms/step ({n_steps} steps after {n_warm} "
        f"warm-up), peak memory {peak:.2f} GiB, K2 launches {k2}, K3 "
        f"launches {k3}; loss {first:.4f} -> {last:.4f} over {len(losses)} "
        f"steps on one batch [{card}]")
    del eng, st, model
    torch.cuda.empty_cache()


def phase_quant(state):
    import contextlib
    import io

    import numpy as np
    import torch
    from horizonnet_tpu_torch.cli.inference import main as cli_main
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.models.layers import (BatchNorm2d, QuantConvBN,
                                                    WrapConv)
    from horizonnet_tpu_torch.models.quant import quantize_state_dict
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    card = state["card"]
    B, n_batches, reps = FLAGSHIP_B, 6, 2
    wire = _flagship_wire(state)
    engs = {"int8": _flagship_engine("cuboid", quant_int8=True),
            "bf16": _flagship_engine("cuboid")}
    xs = [engs["bf16"].put(w) for w in wire]

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(cid.shape == (B, 8, 2) and bool(
            np.isfinite(cid).all() and np.isfinite(z1).all()),
            f"int8 serving result {cid.shape} not finite")
        return cid

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    for eng in engs.values():                               # warm-up
        _serve(eng, wire, finish)
    cid = {k: unpack_cuboid_outputs(e.run(xs[0]))[0] for k, e in engs.items()}
    drift = np.abs(cid["int8"] - cid["bf16"]) * np.array([1024, 512])
    cuda_lstm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _serve(engs["int8"], feed, finish)
    k1 = cuda_lstm.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(k1 == 2 * n_batches, f"K1 launched {k1} times in {n_batches} int8 "
          "forwards of 2 recurrences")
    _launched(state, "bilstm_fwd", "int8 serving", k1)
    serving, device = _in_turns(engs, "int8", "bf16", feed, xs, finish, reps)
    log(f"resnet50_rnn int8 encoder (quant_int8) against the bf16 flagship, "
        f"B={B} dct4 cuboid, same float weights, in turns (int8, bf16, bf16, "
        f"int8) x {reps}: {_turns_line(serving, device)}; int8 peak memory "
        f"{peak:.1f} GiB, K1 launches {k1} in {n_batches} forwards; first "
        f"batch corner drift int8 against bf16 (random weights) max "
        f"{drift.max():.3f} px, median {np.median(drift):.3f} px [{card}]")
    _top_kernels(f"int8 serving, one B={B} batch",
                 lambda: engs["int8"].run(xs[0]), top=12)
    del engs, xs
    torch.cuda.empty_cache()

    # one QuantConvBN at the stem and at stage 1's 3x3: int32 sums on the
    # card equal to the CPU's bit for bit (B=8), then B=64 bf16 timed beside
    # the float conv + batch norm; WrapConv with and without seam_fix
    g = torch.Generator(device="cpu").manual_seed(2)
    cl = torch.channels_last
    for name, (cin, cout, k, st, p, H, W) in (
            ("stem 7x7/2 3->64 at 512x1024", (3, 64, 7, 2, 3, 512, 1024)),
            ("stage-1 3x3 64->64 at 128x256", (64, 64, 3, 1, 1, 128, 256))):
        q = QuantConvBN(cin, cout, k, st, (p, p))
        q.weight_q.copy_(torch.randint(-127, 128, q.weight_q.shape,
                                       generator=g, dtype=torch.int8))
        q.scale.copy_(torch.rand(cout, generator=g) * 1e-2 + 1e-3)
        q.bias.copy_(torch.randn(cout, generator=g) * 0.1)
        xq, _ = q.quantize(torch.randn(8, cin, H, W, generator=g)
                           .contiguous(memory_format=cl))
        want = q.accumulate(xq)
        qd = q.cuda()
        got = qd.accumulate(xq.cuda())
        same = bool(torch.equal(got.cpu(), want))
        xb = torch.randn(FLAGSHIP_B, cin, H, W, generator=g).to(
            "cuda", torch.bfloat16).contiguous(memory_format=cl)
        convs = [WrapConv(cin, cout, k, st, (p, p), seam_fix=f).to(
            "cuda", torch.bfloat16) for f in (False, True)]
        convs[1].load_state_dict(convs[0].state_dict())
        bn = BatchNorm2d(cout).cuda().eval()
        with torch.no_grad():
            y0, y1 = (c(xb) for c in convs)
            ms = {"int8": cuda_ms(lambda: qd(xb)),
                  "bf16": cuda_ms(lambda: bn(convs[0](xb))),
                  "pad": cuda_ms(lambda: convs[0](xb)),
                  "seam_fix": cuda_ms(lambda: convs[1](xb)),
                  "pad_": cuda_ms(lambda: convs[0](xb))}
        log(f"{name}: int8 sums [8 panos] on the card equal the CPU's bit "
            f"for bit: {same}; B={FLAGSHIP_B} bf16 input: QuantConvBN "
            f"(quantize + im2col + _int_mm + dequantize) {ms['int8']:.3f} ms "
            f"against WrapConv + BatchNorm2d {ms['bf16']:.3f} ms; WrapConv "
            f"alone {ms['pad']:.3f} / {ms['pad_']:.3f} ms (materialized wrap "
            f"pad, before and after), seam_fix {ms['seam_fix']:.3f} ms, "
            f"outputs equal bit for bit: {bool(torch.equal(y0, y1))} "
            f"(CUDA events, median) [{card}]")
        check(same, f"{name}: the card's int32 sums differ from the CPU's")
        check(bool(torch.equal(y0, y1)), f"{name}: WrapConv seam_fix "
              "differs from the materialized pad")
        del xb, y0, y1, convs, qd
    torch.cuda.empty_cache()

    # the golden checkpoint quantized: int8 corners against float, f32
    img, want = _golden_inputs()
    x = img[None].astype(np.float32) / 255.0
    ckpt = os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt")
    model, sd = load_trained_model(ckpt, device="cuda")
    qmodel = build_model("resnet18", True, device="cuda", quant_int8=True)
    sdq = quantize_state_dict(sd)
    (cf, zf), (cq, zq) = (
        unpack_cuboid_outputs(InferenceEngine(m, w, postproc="cuboid",
                                              device="cuda")(x))
        for m, w in ((model, sd), (qmodel, sdq)))
    dpx = float(np.abs(cq[0] - cf[0]).max() * 512)
    dz1 = abs(float(zq[0]) - float(zf[0]))
    log(f"golden quantized (f32, TF32 off): int8 corners {dpx:.4f} px from "
        f"the float ones (bar 4), |dz1| {dz1:.4f} (bar "
        f"{0.05 * abs(float(zf[0])) + 1:.3f})")
    check(dpx < 4.0, f"golden int8 corners drifted {dpx} px")
    check(dz1 < 0.05 * abs(float(zf[0])) + 1.0, f"golden int8 z1 off {dz1}")

    # the inference CLI with --quant_int8: host path and device fit
    pano = os.path.join(GOLDEN, "val_room.png")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    for mode, extra in (("host", []), ("device_postproc",
                                       ["--device_postproc"])):
        with tempfile.TemporaryDirectory(
                dir=os.path.join(REPO, "build")) as out:
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                rc = cli_main(["--pth", ckpt, "--img_glob", pano,
                               "--output_dir", out, "--device", "cuda",
                               "--quant_int8", "--force_cuboid", *extra])
            check(rc == 0, f"--quant_int8 CLI ({mode}) returned {rc}: "
                  f"{err.getvalue()[-2000:]}")
            with open(os.path.join(out, "val_room.json")) as f:
                got = json.load(f)
        uv = np.asarray(got["uv"])
        check(uv.shape == (8, 2), f"--quant_int8 CLI ({mode}): {len(uv)} "
              "corners")
        dpx = float(np.abs(uv - want["cuboid_uv"]).max() * 512)
        dz1 = abs(got["z1"] - float(want["cuboid_z1"]))
        log(f"cli --quant_int8 --force_cuboid ({mode}): corners {dpx:.4f} "
            f"px from golden_outputs.npz (float; bar 4), |dz1| {dz1:.4f}")
        check(dpx < 4.0, f"--quant_int8 CLI ({mode}) off by {dpx} px")
        check(dz1 < 0.05 * abs(float(want["cuboid_z1"])) + 1.0,
              f"--quant_int8 CLI ({mode}) z1 off by {dz1}")


PRE_ROTATIONS = {"room": (0, 0), "yaw20_tilt8": (20, 8),
                 "yaw-35_tilt5": (-35, 5)}
PRE_STAGES = ("cut_views", "lsd", "lift", "merge", "hough", "refit",
              "rotate")


def _yaw_tilt(yaw, tilt):
    import numpy as np

    a, b = np.radians(yaw), np.radians(tilt)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]) @ np.array([[1, 0, 0],
                                             [0, np.cos(b), -np.sin(b)],
                                             [0, np.sin(b), np.cos(b)]])


def _vp_deg(a, b):
    """Degrees between the directions of rows a and b, up to sign
    (broadcasts). By atan2: the rows are read from "%.6f" text, and arccos
    of a dot product a rounding below 1 would read 0.06 deg."""
    import numpy as np

    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    a, b = np.broadcast_arrays(a, b)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                                 np.abs((a * b).sum(-1))))


def _vp_rows_deg(a, b):
    """Degrees from each VP row of a to b's: the vertical (row 0) to b's
    vertical, each horizontal (rows 1, 2) to the nearer of b's two, whose
    order flips where the canonical ordering's test nearly ties (a room at
    45 deg of yaw: find_main_direction sorts them by |sin u|)."""
    return [float(_vp_deg(a[0], b[0]))] + [float(_vp_deg(a[k], b[1:3]).min())
                                           for k in (1, 2)]


def _wall_ms(fn, reps=5):
    """Median wall milliseconds of fn() (which ends on the host)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _preprocess_warps(room):
    """The device backend's warps on the card against the host backend at
    512x1024, at the JAX package's bars between its two backends; each
    timed on both (wall ms, transfers included: what the pipeline pays)."""
    import numpy as np
    from horizonnet_tpu_torch.preprocess import rotate, views

    R = _yaw_tilt(20, 8)
    f64, f32 = room.astype(np.float64), room.astype(np.float32)
    cases = (
        ("cut_views_gray", lambda b: views.cut_views_gray(
            room, backend=b, device="cuda"),
         lambda d, h: np.abs(d.astype(np.float32) - h).max(), 0.15, "max"),
        ("cut_views", lambda b: views.cut_views(f64, backend=b,
                                                device="cuda"),
         lambda d, h: np.abs(d - h).max(), 0.2, "max"),
        ("rotate_panorama", lambda b: rotate.rotate_panorama(
            f32, R=R, backend=b, device="cuda"),
         lambda d, h: np.abs(d - h).mean(), 0.05, "mean"),
        ("rotate_panorama_uint8", lambda b: rotate.rotate_panorama_uint8(
            room, R=R, backend=b, device="cuda"),
         lambda d, h: (d != h).mean(), 0.01, "share of values"))
    for name, fn, err, bar, kind in cases:
        dev, host = fn("device"), fn("host")
        check(dev.shape == host.shape, f"{name}: {dev.shape} {host.shape}")
        e = float(err(dev, host))
        ms_d, ms_h = _wall_ms(lambda: fn("device")), _wall_ms(
            lambda: fn("host"))
        log(f"preprocess warp {name} {tuple(dev.shape)}: card against host "
            f"{kind} difference {e:.6g} (bar {bar}); device backend "
            f"{ms_d:.3f} ms, host backend {ms_h:.3f} ms (wall, median of 5)")
        check(e < bar, f"{name}: card against host {e} over {bar}")


def _preprocess_cli(raw_dir, out_root):
    """python -m horizonnet_tpu_torch.cli.preprocess on the raw rooms: the
    default (--device cuda: the device backend) and the host backend by
    HORIZONNET_PREPROCESS_BACKEND, each in its own process; then --rgbonly
    through the CLI's main() in this one (a process takes ~10 s to start).
    Returns the VP rows of each backend by room."""
    import numpy as np
    from horizonnet_tpu_torch.cli import preprocess
    from horizonnet_tpu_torch.utils.image import read_png

    vps = {}
    for run in ("device", "host", "rgbonly"):
        out = os.path.join(out_root, run)
        flags = ["--img_glob", os.path.join(raw_dir, "*.png"),
                 "--output_dir", out]
        t0 = time.perf_counter()
        if run == "rgbonly":
            check(preprocess.main(flags + ["--rgbonly"]) == 0,
                  "preprocess CLI --rgbonly failed")
        else:
            env = dict(os.environ, PYTHONPATH=REPO)
            env.pop("HORIZONNET_PREPROCESS_BACKEND", None)
            if run == "host":
                env["HORIZONNET_PREPROCESS_BACKEND"] = "host"
            proc = subprocess.run(
                [sys.executable, "-m", "horizonnet_tpu_torch.cli.preprocess",
                 *flags, "--profile"], cwd=REPO, env=env,
                capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"preprocess CLI ({run}) failed "
                  f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        log(f"preprocess CLI ({run}): {time.perf_counter() - t0:.1f} s for "
            f"{len(PRE_ROTATIONS)} panos"
            + ("" if run == "rgbonly" else ", process start included"))
        kinds = [""] if run == "rgbonly" else ["_aligned_rgb",
                                               "_aligned_line"]
        for name in PRE_ROTATIONS:
            for kind in kinds:
                img = read_png(os.path.join(out, f"{name}{kind}.png"))
                check(img.shape == (512, 1024, 3) and img.dtype == np.uint8,
                      f"preprocess CLI ({run}) {name}{kind}.png: "
                      f"{img.shape} {img.dtype}")
            if run != "rgbonly":
                vps.setdefault(run, {})[name] = np.loadtxt(
                    os.path.join(out, f"{name}_VP.txt"))
    return vps


def phase_preprocess(state):
    """The preprocess branch on the card: native builds, the warps card
    against host, the CLI on raw panos with the VP checks, and the chained
    raw -> aligned -> corners pipeline, host and device backends in
    turns."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from horizonnet_tpu_torch.inference import serve_stream
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.ops.dct import pack_dct4
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.preprocess import (_build, host_resample, lsd,
                                                 native)
    from horizonnet_tpu_torch.preprocess import (pano_edge_detection,
                                                 rotate_panorama_uint8)
    from horizonnet_tpu_torch.utils.image import write_png
    from horizonnet_tpu_torch.utils.profiling import stage_timer

    t0 = time.perf_counter()
    libs = {"lsd": lsd._load(), "merge": native._load(),
            "vote": native._load_vote(), "warp": host_resample._warp()}
    check(libs["warp"] is not None, "warp.cpp did not build: the host "
          "backend would run its numpy twin")
    for name, lib in libs.items():
        check(os.path.dirname(lib._name) == _build.BUILD_DIR,
              f"{name}: loaded {lib._name}, not a build of the checkout")
    log(f"preprocess native builds (g++ from the checkout into "
        f"build/preprocess/): {time.perf_counter() - t0:.1f} s, "
        + ", ".join(os.path.basename(lib._name) for lib in libs.values()))

    room, _ = _golden_inputs()
    _preprocess_warps(room)

    raws = {n: (room if n == "room" else host_resample
                .rotate_panorama_uint8_host(room, R=_yaw_tilt(*yt)))
            for n, yt in PRE_ROTATIONS.items()}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        raw_dir = os.path.join(d, "raw")
        os.makedirs(raw_dir)
        for name, pano in raws.items():
            write_png(os.path.join(raw_dir, f"{name}.png"), pano)
        vps = _preprocess_cli(raw_dir, d)
    vp0 = vps["device"]["room"]
    for name, yt in PRE_ROTATIONS.items():
        dev, host = vps["device"][name], vps["host"][name]
        between = max(_vp_rows_deg(dev, host))
        vert, *horiz = _vp_rows_deg(dev, vp0 @ _yaw_tilt(*yt).T)
        log(f"preprocess CLI VP {name}: device against host backend "
            f"{between:.6f} deg (bar 0.05); against R vp0: vertical "
            f"{vert:.4f} deg (bar 0.1), horizontals "
            f"{horiz[0]:.4f}, {horiz[1]:.4f} deg (bar 1.5)")
        check(between < 0.05, f"{name}: backends' VPs {between} deg apart")
        check(vert < 0.1, f"{name}: vertical VP {vert} deg from R vp0")
        check(max(horiz) < 1.5, f"{name}: horizontal VP {horiz} deg off")

    # the chain (bench.py's e2e recipe): a thread pool VP-aligns raw panos
    # while serve_stream keeps the card fed with batches of 8
    B, n_panos, reps = 8, 64, 3
    W = room.shape[1]
    rng = np.random.default_rng(1)
    bases = list(raws.values())
    panos = [np.roll(bases[i % len(bases)], int(r), axis=1)
             for i, r in enumerate(rng.integers(0, W, n_panos))]
    workers = min(8, os.cpu_count() or 1)
    eng = _flagship_engine("cuboid", batch_size=B)

    def preprocess_one(pano, backend):
        """(aligned pano, VP found). Where the room's 2-3 lines give no
        orthogonal triple (2 of these 64 panos on the CPU, in the JAX
        package too), the CLI skips the pano with a warning; the chain
        serves it as it came, and counts it."""
        r = pano_edge_detection(pano, want_pano_edge=False, lsd_workers=1,
                                backend=backend, device="cuda")
        if r["vp"] is None:
            return pano, False
        with stage_timer("preprocess/rotate"):
            return rotate_panorama_uint8(pano, r["vp"][2::-1],
                                         backend=backend,
                                         device="cuda"), True

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(cid.shape == (B, 8, 2) and bool(np.isfinite(cid).all()
                                              and np.isfinite(z1).all()),
              "chain result not finite")
        return cid

    def chain(backend):
        results, found = [], []
        t = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            aligned = pool.map(lambda p: preprocess_one(p, backend), panos)

            def feed():
                buf = []
                for a, ok in aligned:
                    found.append(ok)
                    buf.append(a)
                    if len(buf) == B:
                        yield pack_dct4(np.stack(buf))
                        buf = []

            for res in serve_stream(eng, feed(), depth=2, finish=finish):
                results.extend(res)
        rate = n_panos / (time.perf_counter() - t)
        check(len(results) == n_panos, f"chain returned {len(results)}")
        return rate, tuple(i for i, ok in enumerate(found) if not ok)

    single, split = {}, {}
    for backend in ("host", "device"):
        check(preprocess_one(panos[0], backend)[1],  # warm, untimed
              "VP detection failed on the warm-up pano")
        before = dict(stage_timer.totals)
        times = []
        for p in panos[1:9]:
            t = time.perf_counter()
            preprocess_one(p, backend)
            times.append(time.perf_counter() - t)
        single[backend] = statistics.median(times)
        split[backend] = {
            k: (stage_timer.totals[f"preprocess/{k}"]
                - before.get(f"preprocess/{k}", 0.0)) / len(times) * 1e3
            for k in PRE_STAGES}
        log(f"preprocess_s_per_pano ({backend} backend, one pano at a time, "
            f"lsd_workers=1, median of {len(times)} warm panos): "
            f"{single[backend]:.4f} s; per stage ms a pano: "
            + ", ".join(f"{k} {v:.2f}" for k, v in split[backend].items()))

    eng(pack_dct4(np.stack([room] * B)))            # warm the engine
    torch.cuda.synchronize()
    rates = {"host": [], "device": []}
    misses = {"host": set(), "device": set()}
    stages = {b: dict.fromkeys(PRE_STAGES, 0.0) for b in rates}
    cuda_lstm.launches = 0
    for _ in range(reps):
        for backend in ("host", "device"):
            before = dict(stage_timer.totals)
            rate, missed = chain(backend)
            rates[backend].append(rate)
            misses[backend].add(missed)
            for k in PRE_STAGES:
                stages[backend][k] += (
                    stage_timer.totals[f"preprocess/{k}"]
                    - before.get(f"preprocess/{k}", 0.0)) / reps / n_panos
    launches = cuda_lstm.launches
    for backend, seen in misses.items():
        # one backend sees the same panos in every run, and the pipeline is
        # deterministic: a miss that moves between runs would be a race
        check(len(seen) == 1, f"the chain's {backend} runs found no VP on "
              f"different panos: {sorted(seen)}")
        log(f"chain ({backend} backend): no VP found (served as they came) "
            f"on {len(next(iter(seen)))} of {n_panos} panos, the same in "
            f"every run: {list(next(iter(seen)))}")
    _launched(state, "bilstm_fwd", "preprocess chain", launches)
    log(f"e2e_panos_per_sec (raw -> VP align on {workers} threads -> "
        f"resnet50_rnn bf16 B={B} dct4 cuboid, serve_stream depth 2, "
        f"{n_panos} panos a run, backends in turns): host "
        f"{statistics.median(rates['host']):.2f} (runs "
        f"{[round(v, 2) for v in rates['host']]}), device "
        f"{statistics.median(rates['device']):.2f} (runs "
        f"{[round(v, 2) for v in rates['device']]}); K1 launches "
        f"{launches} [{state['card']}]")
    for backend, split in stages.items():
        log(f"chain ({backend} backend) per stage ms a pano in its thread, "
            f"beside {workers - 1} others: "
            + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in split.items()))


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
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from horizonnet_tpu_torch.ops import (cuda_lstm, cuda_lstm_train,
                                          fused_block)

    def record(name, source, replaces):
        return {"name": name, "route": "cuda",
                "source": f"horizonnet_tpu_torch/csrc/{source}",
                "replaces": f"horizonnet_tpu/ops/{replaces}",
                "launches": None, "max_abs_err": None, "ms": None,
                "plain_ms": None, "bound_ms": None, "bound_by": None,
                "library_ms": None}

    state = {"card": card_line(), "launches": {}, "kernels": {
        "bilstm_fwd": record("bilstm_fwd", "bilstm_fwd.cu",
                             "pallas_lstm.py:31"),
        "bilstm_train_fwd": record("bilstm_train_fwd", "bilstm_train.cu",
                                   "pallas_lstm.py:56"),
        "bilstm_bwd": record("bilstm_bwd", "bilstm_train.cu",
                             "pallas_lstm.py:87"),
        "fused_bottleneck": record("fused_bottleneck", "fused_bottleneck.cu",
                                   "pallas_block.py:58")}}
    log(state["card"])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(m.build)
                  for m in (cuda_lstm, cuda_lstm_train, fused_block)]:
            f.result()
    log(f"K1, K2/K3 and K4 builds (nvcc in parallel, or the cached "
        f"libraries): {time.perf_counter() - t0:.1f} s")

    phases = {"kernel": phase_kernel, "golden": phase_golden,
              "flagship": phase_flagship, "fused": phase_fused,
              "general": phase_general, "cli": phase_cli,
              "host": phase_host, "train": phase_train,
              "train_cli": phase_train_cli, "dynamics": phase_dynamics,
              "densenet": phase_densenet, "quant": phase_quant,
              "preprocess": phase_preprocess}
    for name in args.phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        phases[name](state)
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")

    log(f"launches by path (each counted from 0 just before its run; the "
        f"kernels line sums them): {json.dumps(state['launches'])}")
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": list(state["kernels"].values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
