#!/usr/bin/env python3
"""Drive the PyTorch port (horizonnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase, as a release check
    python3 chip_smoke.py --phases kernel train train_cli   # a subset
    python3 chip_smoke.py --phases kernel fused general     # K4, general
    python3 chip_smoke.py --phases host dynamics train_cli  # host path,
                                                            # validation
    python3 chip_smoke.py --phases kernel densenet quant    # model options
    python3 chip_smoke.py --phases preprocess               # VP alignment
    python3 chip_smoke.py --phases eval                     # evals, tools
    python3 chip_smoke.py --phases parity                   # parity_eval
    python3 chip_smoke.py --phases kernel flagship bench    # the benches
    python3 chip_smoke.py --phases kernel parallel          # the mesh
    python3 chip_smoke.py --phases pad                      # K5

Phases; any failed check makes the script exit non-zero:
  kernel    build K1 (csrc/bilstm_fwd.cu), the training pair K2/K3
            (csrc/bilstm_train.cu) and the fused bottleneck K4
            (csrc/fused_bottleneck.cu) from the checkout, one nvcc each, in
            parallel, and hold each against its plain PyTorch twin: f32 at
            a small shape (tol 1e-5) and bf16 at the main path's shape (K1
            at serving T=256, D=2, B=64, H=512; K2/K3 at training B=8 and
            at the reference recipe's B=24),
            tol 1e-2 relative to the largest entry (the bf16 output
            rounding: a one-ulp flip is 2^-7 of the value); K1's bf16
            output must also equal the twin's bit for bit on at least
            99.98 % of its entries (its three-term products keep the f32
            contract; products of one or two terms fall below), and at the
            training shapes K2's ys, gates and cs on at least 99.98 % and
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
            serve_stream at depth 3: finite [8, 2] corners. Two engines,
            the captured program (InferenceEngine's default on the card)
            and the eager one (graph=False): the captured output equal to
            the eager one bit for bit on the three wire batches; K1
            launched twice and K5's pad 33 times a batch by both (a
            replay counts its captured launches); the host's ms in put() and in run() while batches
            run on the card, beside one batch's device ms and what an
            upload from pageable memory waits there (put must take under
            a quarter of a batch); serving and device-resident panos/s of
            both in turns; each engine's peak memory (the captured one's
            with its graph's pool).
  fused     the flagship with fused_blocks="kernel" (K4 on the 12
            identity bottlenecks) beside the unfused flagship, same
            weights, in turns: serving and device panos/s, corner drift
            on the first batch, K4 launches (12 per forward); K4 under
            capture: the fused engine's replays equal to the same
            weights' eager program bit for bit on the three wire batches,
            12 launches a replay; then an f32
            resnet50_rnn at B=1, 512x1024 with randomized batch norm, TF32
            off: fused and unfused bon/cor within 2e-4.
  general   the golden through InferenceEngine(postproc="general") in f32
            (12 corners within 2 px of general_uv, z1 within 0.2), then
            through the yuv420 wire (within 2 px); then the flagship's
            width in general mode (resnet50_rnn bf16 B=64 dct4,
            serve_stream depth 3, finish_general_batch on 4 workers):
            serving panos/s of the captured engine and the eager one in
            turns, device panos/s of general and cuboid in turns, every
            result finite.
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
            the card. TrainEngine's captured step (the default on the
            card) against its eager step (graph=False), each from the same
            state: three steps, the third with a new generator (an epoch's
            in the train CLI), must agree within 1e-6 relative in every
            loss, parameter, running statistic and optimizer tensor (the
            differing ones are named; a second eager engine shows the
            eager step's own spread), and advance the generators alike;
            then ms a step of both in turns (eager, graphed, graphed,
            eager) x 3 of 5 steps. Checks: every loss finite, K2 and K3
            launched twice a step, K5's pad 33 and its fold 32 times a
            step (the stem's input takes no gradient), the loss after the
            steps below the
            first step's. Prints train panos/s, peak memory of each
            engine, per-stage times of the eager step and, for each, the
            profiler's device-busy share and top kernels.
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
  eval      the reference's evaluation flow: 16 copies of val_room (the
            first unrolled, the others rolled by columns drawn from seed 1)
            with their labels rolled the same way (val_room_cor.txt, and
            for the cuboid metrics its plan bounding box as an 8-corner
            cuboid); python -m horizonnet_tpu_torch.cli.inference on them
            (the golden checkpoint, host postprocess, f32, TF32 off), with
            and without --force_cuboid; the eval_cuboid and eval_general
            CLIs print what evals.test_cuboid / test_general print in this
            process on the same files, and the unrolled pano's 3DIoU is
            within 2.0 points of the CPU's from golden_outputs.npz; the
            cuboid run with --profile_dir, then --device_postproc (general)
            with --profile_dir: each trace parses and holds the serve/*
            spans of its path and K1 kernel events (a trace without them is
            taken again, up to 3 times); layout_viewer (--out, --html,
            --vis_out) on the card's JSON and the CPU's: the same PLY
            counts, a canvas, a preview that decodes; dataset_vis: the
            card's strips equal the CPU's, and with every augmentation the
            warp runs on the card; horizonnet_tpu_torch/tools/
            trace_serving.py 64 dct4 cuboid 12: the flagship's batch by
            kernel, K1 among them, and the device-busy share.
  parity    horizonnet_tpu_torch/tools/parity_eval.py, the weights-parity
            harness, each run in a fresh process that reports K1's
            launches and its stages' seconds at exit. (1) the golden
            checkpoint in f32 with TF32 off on 16 copies of val_room (the
            first unrolled, the others rolled by columns from seed 1) with
            rolled labels, --dataset custom in --mode general
            (val_room_cor.txt) and --mode cuboid (its plan bounding box as
            an 8-corner cuboid), with --device cuda and again with
            --device cpu: every metric, as the tool's own eval functions
            compute it from the JSONs each run kept, on the card within
            PARITY_TOL points of the CPU's; K1 launched on the card, not
            on the CPU; the verdicts in this process: exit 0 with --expect
            at the card's 3DIoU, exit 2 at 50 points more. (2) full width:
            resnet50_rnn with random weights from seed 0 written as a
            reference .pth, 16 raw panos (val_room and two rotations of it
            by a known R, as in the preprocess phase, rolled from seed 1,
            with rolled labels), --bf16 --device_postproc --batch_size 8
            --need_preprocess: exit 0, every aligned pano scored, finite
            metrics (random weights: no bar), K1 launched; the seconds a
            pano of the alignment, the inference and the eval.
  bench     the port's throughput entry points, each in a fresh process
            that prints its JSON line last: python -m
            horizonnet_tpu_torch.bench with BENCH_REPS=3 BENCH_E2E_N=32
            (the flagship's serving reps, device rate, serving MFU and the
            raw-pano chain against REF_E2E.json), and
            horizonnet_tpu_torch/tools/train_throughput.py 10 24 resnet50
            bf16 pallas_train (the reference recipe: ms a step in each mode,
            the train MFU, peak memory). Every number of both lines present
            and finite, a provisional bench line before the whole one, each
            MFU in (0, 100], K1 launched in the bench and K2/K3 in the
            train run (each reports its counts, from 0 at its start), and
            the bench's device panos/s within 10 % of the flagship phase's
            captured rate when that phase ran.
  parallel  the multi-process layout (horizonnet_tpu_torch/parallel), for
            its semantics: the card machine has one card, so two ranks
            share it and no time here is a multi-GPU speed. Each part in
            fresh processes; a rank's failure fails the phase. (1) python
            -m torch.distributed.run --standalone --nproc_per_node 1 (the
            torchrun entry, one rank on NCCL) of the train CLI, resnet50
            bf16 at 512x1024, batch 8 of 16 synthetic rooms, one epoch of
            2 steps, K2/K3: the rank reports its K2/K3 launches and losses
            at exit, its first two losses within PAR_CLI_BARS of the same
            CLI run without torchrun, epoch_1.ckpt loads. (2) the
            resnet50_rnn train step at 512x1024, global batch 8, on two ranks
            sharing the card over gloo at layouts (2, 1) and (1, 2),
            against the one-process step on the card (same weights, batch
            and dropout seed), in float32 (TF32 off) and in bf16: losses,
            the gathered gradients tensor by tensor and the running
            statistics within PAR_BARS, the parameters after one Adam step
            within one step of one process's; at n_model 2 a rank holds
            half the encoder's parameter bytes; K2/K3 launched on every
            rank; ms a step per layout. (3) data-parallel serving on two
            ranks: the golden f32 (TF32 off) in cuboid and general mode
            within 2 px of golden_outputs.npz on every rank; the flagship
            (resnet50_rnn bf16, B=64, dct4) finite [64, 8, 2] on every
            rank, the same on both, at least PAR_FLAGSHIP_ROWS rows within
            2 px of the one-process engine's (bf16 ties); K1 launched on
            every rank.
  pad       K5 (csrc/wrap_pad.cu), the encoder's wrap pad and its fold
            (the train and flagship phases count its launches): at each
            wrap pad's input of the main path (bf16,
            channels_last; B=24 train, B=64 serve) the pad and the fold
            equal their twins bit for bit, each timed beside its bound
            (bytes once at 3.35 TB/s), the twins and torch.cat with its
            autograd (the pad it replaced), summed over one step's pads.

The general, densenet and quant phases serve through captured engines
too (the default on the card), and every launch count includes replays.

After the log of the phases it prints a summary: the card's name and
power limit, then one compact line of headline numbers a phase
("summary <phase> {json}"), so that they stay inside the end of the
output when only that end is seen. Before the last line it prints one
JSON line {"kernels": [...]} with each kernel's launches on the paths
that run it, summed (K1: the flagship, densenet121 and int8 serving
runs, the preprocess chain, the eval phase's inference CLI runs, the
parity phase's card runs and the bench, each in a fresh process that
reports its count, and the parallel phase's serving ranks; K2, K3: the
resnet50 and densenet121 train runs, train_throughput's run and the
parallel phase's torchrun run and ranks;
K4: the fused run; K5: the pad phase's step and forward; each counted
from 0 just before its run, and logged by path), its error against the
twin, its time beside the twin's, its bound and the library call's time.
K4's times and bound are summed over the 12 calls of one resnet50
forward (2, 3, 5 and 2 at the four stage shapes); K5's over one train
step's 33 pads and 32 folds at B=24.
The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

import argparse
import json
import math
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
          "preprocess", "eval", "parity", "bench", "parallel", "pad")
# H100 SXM peaks: f32 outside the tensor cores and HBM3 (the bf16 peak is
# horizonnet_tpu_torch/utils/flops.py's PEAK_BF16_FLOPS)
PEAK_F32_FLOPS = 67e12
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


def _peak_bf16():
    """The H100's dense bf16 rate, from its one home in the port."""
    from horizonnet_tpu_torch.utils.flops import PEAK_BF16_FLOPS

    return PEAK_BF16_FLOPS


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


def note(state, **numbers):
    """Keep headline numbers of the running phase: main prints them as one
    compact line a phase after the log, so that they stay inside the end
    of the output that a caller may see alone."""
    state["summary"].setdefault(state["phase"], {}).update(numbers)


def _compact(v):
    """``v`` with its floats at 6 significant digits and its numpy or
    torch scalars as Python numbers, for the summary."""
    if isinstance(v, dict):
        return {k: _compact(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_compact(x) for x in v]
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, float):
        return float(f"{v:.6g}")
    return v


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
    note(state, k1_ms_by_batch={1: small[1], 8: small[8], 64: ms_k},
         k1_err_bf16=errbf, k1_same_share=same)
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
    note(state, k1_layer_ms=ms_layer, k1_layer_cudnn_ms=ms_cudnn)
    # K1's route: three exact bf16 products per step on the tensor cores;
    # beside it the bound of the same products as f32 CUDA-core FMAs
    nbytes, flops = lstm_bytes_flops(T, D, B, H, 2)
    bms, by = bound(3 * flops, nbytes, _peak_bf16())
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

    # bf16 at the train phase's batch and at the recipe's batch of 24
    # (horizonnet_tpu_torch/tools/train_throughput.py, the bench phase)
    err2 = err3 = 0.0
    for (T, D, B, H), dtype, tol in (((16, 2, 3, 32), torch.float32, 1e-5),
                                     ((256, 2, 8, 512), torch.bfloat16,
                                      1e-2),
                                     ((256, 2, 24, 512), torch.bfloat16,
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
            log(f"K2 bf16 B={B}: (ys, gates, cs) "
                f"{[f'{100 * v:.4f}' for v in same2]} % equal to the twin's "
                f"bit for bit (at least {100 * K2_SAME_BAR:g} %); K3 dxw "
                f"{100 * same3:.4f} % (at least {100 * K3_SAME_BAR:g} %)")
            check(min(same2) >= K2_SAME_BAR, f"K2 bf16 equals the twin on "
                  f"{same2} of its outputs: its products lose the f32 "
                  "contract")
            check(same3 >= K3_SAME_BAR, f"K3 bf16 equals the twin on "
                  f"{same3} of its outputs: its products lose the f32 "
                  "contract")
            note(state, **{f"k2_same_share_b{B}": min(same2),
                           f"k3_same_share_b{B}": same3})
            if B == TRAIN_B:
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
    note(state, k2_ms_by_batch=ms2b, k3_ms_by_batch=ms3b,
         k2_k3_host_ms=host, train_layer_ms=ms_port_fb,
         train_layer_cudnn_ms=ms_cudnn_fb)
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
        bms, by = bound(3 * flops, nbytes, _peak_bf16())
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
    by_stage = {k: [] for k in tot}
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
        bms, by = bound(flops, nbytes, _peak_bf16())
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
            by_stage[k].append(v)
        t_ops += n * flops / _peak_bf16()
        t_bytes += n * nbytes / PEAK_BYTES
    log(f"K4 over the 12 identity blocks of one resnet50 forward (B=64, bf16)"
        f": kernel {tot['ms']:.3f} ms, plain twin {tot['plain_ms']:.3f} ms, "
        f"unfused Bottlenecks {tot['library_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.3f} ms [{card}]")
    note(state, k4_stage_ms=by_stage["ms"],
         k4_stage_unfused_ms=by_stage["library_ms"],
         k4_stage_bound_ms=by_stage["bound_ms"], k4_bf16_edge_worst=worst)
    state["kernels"]["fused_bottleneck"].update(
        max_abs_err=err, bound_by="operations" if t_ops >= t_bytes
        else "bytes", **tot)


def _pad_inputs(B):
    """{(shape, pad): count} of the wrap pads one resnet50 HorizonNet
    forward at 512x1024 takes at batch B (the stem, the bottlenecks' 3x3
    convs and the height stage's convs), read at batch 1 on the card."""
    import collections

    import torch
    from horizonnet_tpu_torch.models import build_model, layers
    from horizonnet_tpu_torch.ops import pad as wp

    seen = collections.Counter()

    def record(x, pad, dim=-1):
        seen[(B, *x.shape[1:]), pad] += 1
        return wp.wrap_pad_width(x, pad, dim)

    model = build_model("resnet50", True, device="cuda",
                        dtype=torch.bfloat16, seed=0)
    layers.wrap_pad_width = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 512, 1024, device="cuda"))
    finally:
        layers.wrap_pad_width = wp.wrap_pad_width
    return dict(seen)


def _bits(t):
    import torch

    t = t.contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def phase_pad(state):
    """K5 (csrc/wrap_pad.cu): at every wrap pad's input of the main path
    (bf16, channels_last; B = 24 train, B = 64 serve) the pad and the fold
    equal their twins bit for bit and are timed beside their bound (bytes
    once at 3.35 TB/s), the twins, and the pad this replaced: torch.cat of
    two narrowed views forward, its autograd backward (zero-filled narrow
    gradients and the adds into the input's gradient). The train and
    flagship phases count its launches on the main path."""
    import torch
    from horizonnet_tpu_torch.ops import pad as wp

    card, dev = state["card"], torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(5)
    totals = {}
    for what, B in (("train", 24), ("serve", 64)):
        tot = dict.fromkeys(("ms", "bound_ms", "plain_ms", "cat_ms"), 0.0)
        for ((_, C, H, W), p), n in sorted(_pad_inputs(B).items()):
            x = torch.randn(B, C, H, W, generator=g).to(
                dev, torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
            dpad = torch.randn(B, C, H, W + 2 * p, generator=g).to(
                dev, torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
            grad = what == "train" and C != 3      # the stem's input: none
            check(torch.equal(_bits(wp.wrap_pad_cuda(x, p)),
                              _bits(wp.wrap_pad_plain(x, p))),
                  f"K5 pad differs from its twin at {(B, C, H, W, p)}")
            nbytes = (2 * W + 2 * p) * B * C * H * 2
            ms = cuda_ms(lambda: wp.wrap_pad_cuda(x, p))
            mp = cuda_ms(lambda: wp.wrap_pad_plain(x, p))
            xg = x.detach().requires_grad_(grad)

            def parent():
                y = torch.cat([xg.narrow(3, W - p, p), xg,
                               xg.narrow(3, 0, p)], 3)
                if grad:
                    y.backward(dpad)
                    xg.grad = None
            mc = cuda_ms(parent)
            if grad:
                check(torch.equal(_bits(wp.wrap_fold_cuda(dpad, p)),
                                  _bits(wp.wrap_fold_plain(dpad, p))),
                      f"K5 fold differs from its twin at {(B, C, H, W, p)}")
                ms += cuda_ms(lambda: wp.wrap_fold_cuda(dpad, p))
                mp += cuda_ms(lambda: wp.wrap_fold_plain(dpad, p))
                nbytes *= 2
            bms = nbytes / PEAK_BYTES * 1e3
            log(f"K5 {what} [B={B},C={C},H={H},W={W},p={p}] x{n}"
                f"{' pad + fold' if grad else ' pad'}: kernel {ms:.4f} ms, "
                f"bound {bms:.4f} ms ({nbytes / 1e6:.1f} MB), at "
                f"{100 * bms / ms:.1f} %; twin {mp:.4f} ms; torch.cat"
                f"{' + autograd' if grad else ''} {mc:.4f} ms")
            for k, v in (("ms", ms), ("bound_ms", bms), ("plain_ms", mp),
                         ("cat_ms", mc)):
                tot[k] += n * v
        log(f"K5 over one {what} step's pads (B={B}, bf16): kernel "
            f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms (at "
            f"{100 * tot['bound_ms'] / tot['ms']:.1f} %), twins "
            f"{tot['plain_ms']:.3f} ms, torch.cat"
            f"{' + autograd' if what == 'train' else ''} "
            f"{tot['cat_ms']:.3f} ms [{card}]")
        totals[what] = tot
    note(state, k5_train=totals["train"], k5_serve=totals["serve"])
    state["kernels"]["wrap_pad"].update(
        max_abs_err=0.0, bound_by="bytes", ms=totals["train"]["ms"],
        plain_ms=totals["train"]["plain_ms"],
        bound_ms=totals["train"]["bound_ms"],
        library_ms=totals["train"]["cat_ms"])


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
        note(state, **{f"{name}_px": dpx, f"{name}_dz1": dz1})
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
                     quant_int8=False, batch_size=FLAGSHIP_B, mesh=None,
                     graph=True):
    """resnet50_rnn (or ``backbone``), bf16, the flagship batch (or
    ``batch_size``), dct4 wire, random weights (seed 0); ``quant_int8``:
    the int8 encoder on the same float weights folded by
    models/quant.py::quantize_state_dict; ``mesh``: data-parallel;
    ``graph``: InferenceEngine's (True: captured, as without a mesh by
    default; False: the eager program)."""
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
                           device="cuda", mesh=mesh, graph=graph)


def _resident(wire):
    """The wire batches as tensors on the card (device-resident rates)."""
    import torch

    return [torch.from_numpy(w).cuda() for w in wire]


def _serve(eng, feed, finish, workers=1):
    """serve_stream at depth 3 over feed: (panos/s, results)."""
    from horizonnet_tpu_torch.inference import serve_stream

    t0 = time.perf_counter()
    results = list(serve_stream(eng, iter(feed), depth=3, finish=finish,
                                workers=workers))
    return len(feed) * FLAGSHIP_B / (time.perf_counter() - t0), results


def _host_call_ms(eng, wire, n=6):
    """Host ms of one ``put`` and of one ``run`` while the device is busy:
    two batches are queued first, then n put/run pairs; medians."""
    import torch

    torch.cuda.synchronize()
    for w in wire[:2]:
        eng.run(eng.put(w))
    puts, runs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        up = eng.put(wire[i % len(wire)])
        t1 = time.perf_counter()
        eng.run(up)
        t2 = time.perf_counter()
        puts.append((t1 - t0) * 1e3)
        runs.append((t2 - t1) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(puts), statistics.median(runs)


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
    from horizonnet_tpu_torch.ops import pad as wp
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs

    B, n_batches, reps = FLAGSHIP_B, 12, 2
    card = state["card"]
    wire = _flagship_wire(state)

    def finish(outs):
        cid, z1 = unpack_cuboid_outputs(outs)
        check(cid.shape == (B, 8, 2) and z1.shape == (B,),
              f"flagship result shapes {cid.shape} {z1.shape}")
        check(bool(np.isfinite(cid).all() and np.isfinite(z1).all()),
              "flagship result not finite")
        return cid

    # the eager program and the captured one, each with its own model from
    # the same seed; each engine's peak memory over what was allocated
    # before it (the captured one's includes its graph's pool)
    engs, peak = {}, {}
    for name, graph in (("eager", False), ("graphed", True)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engs[name] = _flagship_engine("cuboid", graph=graph)
        t_build = time.perf_counter() - t0
        _serve(engs[name], wire, finish)                       # warm-up
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"flagship {name} engine: built in {t_build:.1f} s (warm-up "
            f"and capture included), then {len(wire)} batches; peak "
            f"{peak[name]:.2f} GiB over the {base / 2 ** 30:.2f} GiB "
            "before it")
    check(engs["eager"].program is None
          and engs["graphed"].program is not None,
          "the flagship engine did not capture its program")

    # the same numbers: the captured program against the eager one, bit
    # for bit on the three wire batches
    same = [bool(torch.equal(engs["graphed"](w), engs["eager"](w)))
            for w in wire]
    check(all(same), f"graphed flagship output differs from the eager "
          f"program's on batches {[i for i, v in enumerate(same) if not v]}")

    # K1's and K5's launches a batch, a replay's counted as the eager
    # calls are
    k1, k5 = {}, {}
    for name, eng in engs.items():
        cuda_lstm.launches = wp.fwd_launches = 0
        eng(wire[0])
        torch.cuda.synchronize()
        k1[name], k5[name] = cuda_lstm.launches, wp.fwd_launches
    check(k1["graphed"] == k1["eager"] == 2,
          f"K1 launches a batch: graphed {k1['graphed']}, eager "
          f"{k1['eager']}, not 2 each")
    check(k5["graphed"] == k5["eager"] == 33,
          f"K5 pads a batch: graphed {k5['graphed']}, eager {k5['eager']}, "
          "not 33 each")

    # the host's time in put() and run() while batches run on the card,
    # and what an upload from pageable memory (the port's put before the
    # upload ring) waits there
    calls = {name: _host_call_ms(eng, wire) for name, eng in engs.items()}
    dev = torch.device("cuda")
    engs["graphed"].run(engs["graphed"].put(wire[0]))
    t0 = time.perf_counter()
    torch.from_numpy(wire[1]).to(dev)
    pageable_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    batch_ms = cuda_ms(lambda: engs["graphed"].run(engs["graphed"].put(
        wire[0])), reps=5)
    log(f"host ms while the card runs batches (medians of 6): put "
        f"{calls['graphed'][0]:.3f} graphed / {calls['eager'][0]:.3f} "
        f"eager, run {calls['graphed'][1]:.3f} graphed / "
        f"{calls['eager'][1]:.3f} eager; one batch on the card "
        f"{batch_ms:.2f} ms (graphed, CUDA events); an upload from pageable "
        f"memory behind a running batch {pageable_ms:.2f} ms [{card}]")
    check(calls["graphed"][0] < 0.25 * batch_ms,
          f"put took {calls['graphed'][0]:.2f} ms of a {batch_ms:.2f} ms "
          "batch: it waits for the device")

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    xs = _resident(wire)
    cuda_lstm.launches = wp.fwd_launches = wp.bwd_launches = 0
    serving, device = _in_turns(engs, "eager", "graphed", feed, xs, finish,
                                reps)
    launches, pads = cuda_lstm.launches, wp.fwd_launches
    forwards = 8 * reps * n_batches
    check(launches == 2 * forwards, f"K1 launched {launches} times in "
          f"{forwards} forwards of 2 recurrences")
    check(pads == 33 * forwards and wp.bwd_launches == 0,
          f"K5 padded {pads} and folded {wp.bwd_launches} times in "
          f"{forwards} forwards of 33 pads")
    _launched(state, "bilstm_fwd", "flagship", launches)
    _launched(state, "wrap_pad", "flagship", pads)
    med, dmed = _medians(serving), _medians(device)
    log(f"flagship resnet50_rnn bf16 B={B} dct4 cuboid, eager and graphed "
        f"in turns (eager, graphed, graphed, eager) x {reps}, runs of "
        f"{n_batches} batches at depth 3: {_turns_line(serving, device)}; "
        f"peak memory eager {peak['eager']:.2f}, graphed "
        f"{peak['graphed']:.2f} GiB; K1 launches {launches}, K5 pads {pads} "
        f"[{card}]")
    state["flagship_device"] = dmed["graphed"]
    note(state, serving=med, device=dmed, peak_gib=peak,
         same_bits=sum(same), k1_a_batch=k1["graphed"],
         k5_a_batch=k5["graphed"],
         put_ms={k: v[0] for k, v in calls.items()},
         run_ms={k: v[1] for k, v in calls.items()},
         batch_ms=batch_ms, pageable_put_ms=pageable_ms)


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
    xs = _resident(wire)

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

    # K4 under capture: the fused engine's replay against the eager
    # program of the same weights, bit for bit on every wire batch
    eager = _flagship_engine("cuboid", fused_blocks="kernel", graph=False)
    check(engs["fused"].program is not None, "the fused engine did not "
          "capture its program")
    fused_block.launches = 0
    same = [bool(torch.equal(engs["fused"].run(x), eager.run(x)))
            for x in xs]
    torch.cuda.synchronize()
    check(fused_block.launches == 24 * len(xs), f"K4 launched "
          f"{fused_block.launches} times in {len(xs)} replays and eager "
          "forwards, not 12 each")
    check(all(same), "the captured fused program differs from its eager "
          f"run on batches {[i for i, v in enumerate(same) if not v]}")
    log(f"fused flagship captured: {sum(same)} of {len(xs)} batches equal "
        "to the eager program bit for bit, 12 K4 launches a replay")
    del eager
    note(state, drift_max_px=float(drift.max()), captured_same=sum(same))

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
    note(state, serving=med, device=dmed)
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
    note(state, f32_bon_diff=db, f32_cor_diff=dc)
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
        note(state, **{f"golden_{fmt}_px": dpx, f"golden_{fmt}_dz1": dz1})
        check(dpx < 2.0, f"golden general ({fmt}) corners off by {dpx} px")
        if fmt == "float":
            check(dz1 < 0.2, f"golden general z1 off by {dz1}")

    n_batches, reps = 12, 2
    wire = _flagship_wire(state)
    engs = {"general": _flagship_engine("general"),
            "cuboid": _flagship_engine("cuboid"),
            "general eager": _flagship_engine("general", graph=False)}

    def finish(outs):
        res = finish_general_batch(outs)
        check(len(res) == FLAGSHIP_B and all(
            np.isfinite(c).all() and np.isfinite(z1) for c, _, z1 in res),
            "general result not finite")
        return res

    feed = [wire[i % len(wire)] for i in range(n_batches)]
    # serving, the captured engine and the eager one in turns
    for name in ("general", "general eager"):
        _serve(engs[name], wire, finish, 4)                   # warm-up
    serving = {"general": [], "general eager": []}
    for name in ("general eager", "general", "general",
                 "general eager") * reps:
        serving[name].append(_serve(engs[name], feed, finish, 4)[0])
    xs = _resident(wire)
    device = {"general": [], "cuboid": []}
    for name in ("general", "cuboid", "cuboid", "general") * reps:
        device[name].append(_device_rate(engs[name], xs, n_batches))
    outs = engs["general"].run(xs[0])
    t0 = time.perf_counter()
    finish(outs)
    t_tail = time.perf_counter() - t0
    dmed = {k: statistics.median(v) for k, v in device.items()}
    smed = _medians(serving)
    log(f"general resnet50_rnn bf16 B=64 dct4, serve_stream depth 3 with "
        f"finish_general_batch on 4 workers, eager and graphed in turns: "
        f"serving graphed {smed['general']:.1f}, eager "
        f"{smed['general eager']:.1f} panos/s (runs "
        f"{[round(v, 1) for v in serving['general']]} / "
        f"{[round(v, 1) for v in serving['general eager']]}); device general "
        f"{dmed['general']:.1f}, cuboid {dmed['cuboid']:.1f} panos/s in "
        f"turns (runs {[round(v, 1) for v in device['general']]} / "
        f"{[round(v, 1) for v in device['cuboid']]}); the host tail of one "
        f"batch (fetch + finish_general_batch, one thread) "
        f"{t_tail * 1e3:.1f} ms [{card}]")
    note(state, serving=smed, device=dmed, tail_ms=t_tail * 1e3)


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
    from horizonnet_tpu_torch.program import WARMUP
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
            note(state, **{f"golden_cli_{mode}_px": dpx})
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
    # the first call at B=64 builds the cached engine, whose warm-up runs
    # the forward eagerly before the capture
    forwards = WARMUP
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
    note(state, forward_ms=ms_dev, postprocess_ms_a_pano=ms_pano,
         e2e=med)
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
    val_engine = InferenceEngine(model, model.state_dict(), batch_size=1,
                                 H=H, W=W, device=dev)
    cuda_lstm.launches = 0
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
    note(state, train_s=t_train, loss=[early, late], heldout_3diou=iou3d,
         validate_3diou=v["3DIoU"])
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
    from horizonnet_tpu_torch.ops import pad as wp
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.models.horizonnet import loss_terms
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)

    B, H, W, n_steps, reps = TRAIN_B, 512, 1024, 5, 3
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
    note(state, batch_s=t_batch, augment_ms=ms_aug)

    def make(graph):
        model = build_model("resnet50", True, device=dev,
                            dtype=torch.bfloat16, lstm_impl="kernel_train",
                            param_dtype=torch.float32, seed=0)
        st = create_train_state(model, make_optimizer(
            "Adam", warmup_poly_schedule(1e-4, 1000)))
        return TrainEngine(model, st, B, H, W, device=dev, graph=graph)

    # the eager step and the captured one from the same state: three steps
    # each, the third with a new generator (as the train CLI makes one an
    # epoch); each engine's peak memory over what was allocated before it
    engs, peak, first3, gens = {}, {}, {}, {}
    for name, graph in (("eager", False), ("eager2", False),
                        ("graphed", True)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = engs[name] = make(graph)
        t_build = time.perf_counter() - t0
        gens[name] = [torch.Generator(device=dev).manual_seed(s)
                      for s in (0, 0, 1)]
        first3[name] = [eng.step(x, y_bon, y_cor, g) for g in gens[name]]
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"train {name} engine: built in {t_build:.1f} s (warm-up and "
            f"capture included); build and 3 steps peak {peak[name]:.2f} "
            f"GiB over the {base / 2 ** 30:.2f} GiB before it")
    check(engs["eager"].program is None
          and engs["graphed"].program is not None,
          "the train engine did not capture its step")
    gen_same = all(torch.equal(a.get_state(), b.get_state())
                   for a, b in zip(gens["graphed"], gens["eager"]))
    check(gen_same, "the captured step did not advance the generators as "
          "the eager step does")
    spread = {}
    for other in ("graphed", "eager2"):
        diffs = _state_diffs(engs[other], engs["eager"], first3, other)
        differ = {k: v for k, v in diffs.items() if v > 0}
        spread[other] = diffs
        log(f"3 {other} train steps against 3 eager ones (losses, "
            f"parameters, running statistics, Adam's moments and count: "
            f"{len(diffs)} tensors): {len(diffs) - len(differ)} equal bit "
            f"for bit, largest relative difference "
            f"{max(diffs.values()):.3e}; differing: "
            f"{sorted(differ, key=differ.get, reverse=True)[:8]}")
    worst = max(spread["graphed"].values())
    n_same = sum(v == 0 for v in spread["graphed"].values())
    del engs["eager2"]
    check(worst <= 1e-6, f"graphed train steps differ from eager ones by "
          f"{worst:.3e} relative (bar 1e-6)")

    # ms a step, in turns; the captured engine is the main path
    clt.fwd_launches = clt.bwd_launches = 0
    wp.fwd_launches = wp.bwd_launches = 0
    losses, step_ms = [], {k: [] for k in engs}
    gen = {k: torch.Generator(device=dev).manual_seed(2) for k in engs}
    for name in ("eager", "graphed", "graphed", "eager") * reps:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            m = engs[name].step(x, y_bon, y_cor, gen[name])
            if name == "graphed":
                losses.append(m["total"])
        torch.cuda.synchronize()
        step_ms[name].append((time.perf_counter() - t0) / n_steps * 1e3)
    k2, k3 = clt.fwd_launches, clt.bwd_launches
    k5 = (wp.fwd_launches, wp.bwd_launches)
    steps = 4 * reps * n_steps
    check(k5 == (33 * steps, 32 * steps), f"K5 padded and folded {k5} "
          f"times in {steps} steps of 33 pads and 32 folds")
    losses = [m["total"].item() for m in first3["graphed"]] + [
        v.item() for v in losses]
    check(all(np.isfinite(losses)), f"train losses not finite: {losses}")
    check(k2 == k3 == 2 * steps, f"K2/K3 launched {k2}/{k3} times in "
          f"{steps} steps of 2 recurrences")
    first, last = losses[0], float(np.mean(losses[-3:]))
    check(last < first, f"loss on the repeated batch did not fall: "
          f"{first} -> {last}")
    _launched(state, "bilstm_train_fwd", "train", k2)
    _launched(state, "bilstm_bwd", "train", k3)
    _launched(state, "wrap_pad", "train", sum(k5))
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    log(f"train resnet50_rnn bf16 (f32 params) B={B} {H}x{W} kernel_train, "
        f"in turns (eager, graphed, graphed, eager) x {reps} of {n_steps} "
        f"steps: {med['eager']:.2f} ms/step eager, {med['graphed']:.2f} "
        f"graphed (runs {[round(v, 2) for v in step_ms['eager']]} / "
        f"{[round(v, 2) for v in step_ms['graphed']]}); "
        f"{B * 1e3 / med['graphed']:.2f} panos/s graphed; peak memory eager "
        f"{peak['eager']:.2f}, graphed {peak['graphed']:.2f} GiB; K2 "
        f"launches {k2}, K3 launches {k3}, K5 {k5[0]} pads and {k5[1]} "
        f"folds; loss {first:.4f} -> {last:.4f} "
        f"over {len(losses)} graphed steps on one batch [{card}]")
    note(state, step_ms=med, panos_s=B * 1e3 / med["graphed"],
         peak_gib=peak, bits_equal=n_same, tensors=len(spread["graphed"]),
         worst_rel=worst, eager_spread=max(spread["eager2"].values()),
         loss=[first, last])

    # where the time goes: CUDA events around the parts of one eager step
    st, model = engs["eager"].state, engs["eager"].model
    xs = x.permute(0, 3, 1, 2)
    yb = torch.from_numpy(y_bon).to(dev)
    yc = torch.from_numpy(y_cor).to(dev)

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for q in model.parameters():
            q.grad = None
        ev[0].record()
        bon, cor = model(xs, gen["eager"])
        b, c = loss_terms(bon, cor, yb, yc)
        ev[1].record()
        (b + c).backward()
        ev[2].record()
        st.opt.step()
        ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    parts = [staged() for _ in range(5)]
    stages = [statistics.median(col) for col in zip(*parts)]
    log(f"eager train step stages (CUDA events, median of 5): forward + "
        f"loss {stages[0]:.2f} ms, backward {stages[1]:.2f} ms, optimizer "
        f"{stages[2]:.2f} ms [{card}]")
    note(state, stages_ms=stages)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name in ("graphed", "eager"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                engs[name].step(x, y_bon, y_cor, gen[name])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 3
        # kernels only (CPU operators carry their kernels' time too)
        rows = [(e.self_device_time_total / 1e3 / 3, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy = sum(t for t, _ in rows)
        log(f"profiler, {name} step: device busy {busy:.2f} ms of "
            f"{wall:.2f} ms wall (idle share "
            f"{100 * (1 - busy / wall):.1f} %); top kernels:")
        for t, key in rows[:8]:
            log(f"  {t:8.3f} ms  {100 * t / max(busy, 1e-9):5.1f} %  "
                f"{key[:90]}")
        note(state, **{f"{name}_busy_ms": busy, f"{name}_wall_ms": wall})
        if name == "graphed":
            note(state, top_kernels=[[t, key[:40]] for t, key in rows[:5]])


def _state_diffs(a, b, losses, name):
    """{name: max |a - b| / max |b|} over two TrainEngines' parameters,
    buffers, optimizer state and the losses {engine name: [metrics]} of
    their steps (engine ``name`` against 'eager'); 0 where equal bit for
    bit."""
    import torch

    def rel(x, y):
        if torch.equal(x, y):
            return 0.0
        x, y = x.double(), y.double()
        return ((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()

    out = {}
    for kind, ta, tb in (
            ("param", dict(a.model.named_parameters()),
             dict(b.model.named_parameters())),
            ("buffer", dict(a.model.named_buffers()),
             dict(b.model.named_buffers())),
            ("opt", dict(enumerate(a.state.opt.state_tensors())),
             dict(enumerate(b.state.opt.state_tensors())))):
        for k in ta:
            out[f"{kind}:{k}"] = rel(ta[k].detach(), tb[k].detach())
    for i, (ma, mb) in enumerate(zip(losses[name], losses["eager"])):
        for k in ma:
            out[f"loss{i}:{k}"] = rel(ma[k], mb[k])
    return out


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
    note(state, two_epochs_s=t_a, best_3diou=score, resume_rel=rel)


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
        note(state, **{f"{mode}_px": dpx})
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


def _medians(rates):
    return {k: statistics.median(v) for k, v in rates.items()}


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
    return {"busy_ms": busy, "top": [[t, key[:40]] for t, key in rows[:5]]}


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
    xs = _resident(wire)

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
    note(state, serving=_medians(serving), device=_medians(device),
         peak_gib=peak, profile=_top_kernels(
             f"densenet121 serving, one B={B} batch",
             lambda: engs["densenet121"].run(xs[0])))
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
        note(state, **{f"{bb}_f32_rel": max(rb, rc)})
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
    note(state, train_panos_s=n_steps * TRAIN_B / dt,
         train_step_ms=dt / n_steps * 1e3, train_peak_gib=peak)
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
    xs = _resident(wire)

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
    note(state, serving=_medians(serving), device=_medians(device),
         peak_gib=peak, drift_max_px=float(drift.max()),
         profile=_top_kernels(f"int8 serving, one B={B} batch",
                              lambda: engs["int8"].run(xs[0]), top=12))
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
        note(state, **{name.split()[0] + "_ms": ms})
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
    note(state, golden_int8_px=dpx, golden_int8_dz1=dz1)
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
        note(state, **{f"cli_{mode}_px": dpx})
        check(dpx < 4.0, f"--quant_int8 CLI ({mode}) off by {dpx} px")
        check(dz1 < 0.05 * abs(float(want["cuboid_z1"])) + 1.0,
              f"--quant_int8 CLI ({mode}) z1 off by {dz1}")


PRE_STAGES = ("cut_views", "lsd", "lift", "merge", "hough", "refit",
              "rotate")


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


def _preprocess_warps(state, room):
    """The device backend's warps on the card against the host backend at
    512x1024, at the JAX package's bars between its two backends; each
    timed on both (wall ms, transfers included: what the pipeline pays)."""
    import numpy as np
    from horizonnet_tpu_torch.bench import yaw_tilt
    from horizonnet_tpu_torch.preprocess import rotate, views

    R = yaw_tilt(20, 8)
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
        note(state, **{f"warp_{name}": [e, ms_d, ms_h]})
        check(e < bar, f"{name}: card against host {e} over {bar}")


def _preprocess_cli(raw_dir, out_root):
    """python -m horizonnet_tpu_torch.cli.preprocess on the raw rooms: the
    default (--device cuda: the device backend) and the host backend by
    HORIZONNET_PREPROCESS_BACKEND, each in its own process; then --rgbonly
    through the CLI's main() in this one (a process takes ~10 s to start).
    Returns the VP rows of each backend by room."""
    import numpy as np
    from horizonnet_tpu_torch.bench import PRE_ROTATIONS
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
    from horizonnet_tpu_torch.bench import (PRE_ROTATIONS, raw_panos,
                                            rolled_panos, yaw_tilt)
    from horizonnet_tpu_torch.inference import serve_stream
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.ops.dct import pack_dct4
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.preprocess import (_build, host_resample, lsd,
                                                 native)
    from horizonnet_tpu_torch.preprocess import (pano_edge_detection,
                                                 rotate_panorama_uint8)
    from horizonnet_tpu_torch.utils import profiling
    from horizonnet_tpu_torch.utils.image import write_png

    def stage_s(since):
        """{stage: seconds} of the preprocess spans since ``since`` (ns)."""
        out = dict.fromkeys(PRE_STAGES, 0.0)
        for sp in profiling.spans(since):
            k = sp.name.removeprefix("preprocess/")
            if k in out:
                out[k] += (sp.end - sp.start) / 1e9
        return out

    profiling.enable()
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
    _preprocess_warps(state, room)

    raws = raw_panos(room)
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
        vert, *horiz = _vp_rows_deg(dev, vp0 @ yaw_tilt(*yt).T)
        log(f"preprocess CLI VP {name}: device against host backend "
            f"{between:.6f} deg (bar 0.05); against R vp0: vertical "
            f"{vert:.4f} deg (bar 0.1), horizontals "
            f"{horiz[0]:.4f}, {horiz[1]:.4f} deg (bar 1.5)")
        note(state, **{f"vp_{name}_deg": [between, vert, *horiz]})
        check(between < 0.05, f"{name}: backends' VPs {between} deg apart")
        check(vert < 0.1, f"{name}: vertical VP {vert} deg from R vp0")
        check(max(horiz) < 1.5, f"{name}: horizontal VP {horiz} deg off")

    # the chain (bench.py's e2e recipe): a thread pool VP-aligns raw panos
    # while serve_stream keeps the card fed with batches of 8
    B, n_panos, reps = 8, 64, 3
    panos = rolled_panos(list(raws.values()), n_panos)
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
        with profiling.span("preprocess/rotate"):
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
        since = time.perf_counter_ns()
        times = []
        for p in panos[1:9]:
            t = time.perf_counter()
            preprocess_one(p, backend)
            times.append(time.perf_counter() - t)
        single[backend] = statistics.median(times)
        split[backend] = {k: v / len(times) * 1e3
                          for k, v in stage_s(since).items()}
        log(f"preprocess_s_per_pano ({backend} backend, one pano at a time, "
            f"lsd_workers=1, median of {len(times)} warm panos): "
            f"{single[backend]:.4f} s; per stage ms a pano: "
            + ", ".join(f"{k} {v:.2f}" for k, v in split[backend].items()))
        note(state, **{f"s_a_pano_{backend}": single[backend],
                       f"stages_ms_{backend}": split[backend]})

    eng(pack_dct4(np.stack([room] * B)))            # warm the engine
    torch.cuda.synchronize()
    rates = {"host": [], "device": []}
    misses = {"host": set(), "device": set()}
    stages = {b: dict.fromkeys(PRE_STAGES, 0.0) for b in rates}
    cuda_lstm.launches = 0
    for _ in range(reps):
        for backend in ("host", "device"):
            since = time.perf_counter_ns()
            rate, missed = chain(backend)
            rates[backend].append(rate)
            misses[backend].add(missed)
            for k, v in stage_s(since).items():
                stages[backend][k] += v / reps / n_panos
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
    note(state, chain=_medians(rates), chain_missed={b: len(next(iter(m))) for b, m in misses.items()})
    for backend, split in stages.items():
        log(f"chain ({backend} backend) per stage ms a pano in its thread, "
            f"beside {workers - 1} others: "
            + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in split.items()))
        note(state, **{f"chain_stages_ms_{backend}": {
            k: v * 1e3 for k, v in split.items()}})
    profiling.enable(False)


EVAL_N = 16
EVAL_CLI = "horizonnet_tpu_torch.cli.inference"


def _rolled_cor(cor, r, W=1024):
    """A corner label of a pano rolled by r columns: x shifted modulo W,
    the ceiling/floor pairs back in ascending-x order (the label files')."""
    import numpy as np

    cor = np.array(cor, np.float64)
    cor[:, 0] = (cor[:, 0] + r) % W
    pairs = cor.reshape(-1, 2, 2)
    return pairs[np.argsort(pairs[:, 0, 0], kind="stable")].reshape(-1, 2)


def _plan_box_cuboid(cor, H=512, W=1024, floor_z=-1.6):
    """The cuboid label of a general one: val_room's label is an L-shaped
    room of 6 corners, and the cuboid metrics take 8 (the JAX and the
    port's test_cuboid stop at the corner error's shapes on it). The cuboid
    is the bounding box of its floor ring in the plan, at the floor and
    the mean ceiling height of the label, in pixels, ordered by x."""
    import numpy as np
    from horizonnet_tpu_torch.geometry.equirect_host import (coor2xy,
                                                             coory2v_up,
                                                             xy2coor)

    cor = np.asarray(cor, np.float64)
    floor = coor2xy(cor[1::2], floor_z, W, H, floorW=1, floorH=1)
    ceil_z = float((np.sqrt((floor ** 2).sum(1))
                    * np.tan(coory2v_up(cor[0::2, 1], H))).mean())
    (x0, y0), (x1, y1) = floor.min(0), floor.max(0)
    box = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    out = np.zeros((8, 2))
    out[0::2] = xy2coor(box, ceil_z, W, H, floorW=1, floorH=1)
    out[1::2] = xy2coor(box, floor_z, W, H, floorW=1, floorH=1)
    return _rolled_cor(out, 0, W)


def _cli_counted(args, env):
    """``python -m horizonnet_tpu_torch.cli.inference args`` (runpy runs
    the module as __main__, as -m does), in a fresh process that reports
    K1's launch count, from 0, when it exits: (seconds, K1 launches)."""
    code = "\n".join([
        "import runpy, sys",
        "from horizonnet_tpu_torch.ops import cuda_lstm",
        "try:",
        f"    runpy.run_module({EVAL_CLI!r}, run_name='__main__', "
        "alter_sys=True)",
        "finally:",
        "    print(f'K1_LAUNCHES {cuda_lstm.launches}', file=sys.stderr)"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"inference CLI {args[-3:]} failed "
          f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    n = [int(line.split()[1]) for line in proc.stderr.splitlines()
         if line.startswith("K1_LAUNCHES ")]
    check(len(n) == 1, "the inference CLI did not report K1's launches")
    return dt, n[0]


def _eval_stdout(kind, dt_glob, gt_glob):
    """What eval_cuboid / eval_general print, from evals.test_cuboid /
    test_general called in this process on the same files."""
    import contextlib
    import io

    import numpy as np
    from horizonnet_tpu_torch.evals import (new_general_losses,
                                            prepare_gtdt_pairs,
                                            summarize_general, test_cuboid,
                                            test_general)

    losses = ({"CE": [], "PE": [], "3DIoU": []} if kind == "cuboid"
              else new_general_losses())
    per_pano = []
    for gt_path, dt_path in prepare_gtdt_pairs(gt_glob, dt_glob):
        with open(gt_path) as f:
            gt_cor_id = np.array([line.split() for line in f], np.float32)
        with open(dt_path) as f:
            dt = json.load(f)
        dt_cor_id = np.array(dt["uv"], np.float32)
        dt_cor_id[:, 0] *= 1024
        dt_cor_id[:, 1] *= 512
        if kind == "cuboid":
            test_cuboid(dt_cor_id, dt["z0"], dt["z1"], gt_cor_id, 1024, 512,
                        losses)
            per_pano.append(losses["3DIoU"][-1])
        else:
            test_general(dt_cor_id, gt_cor_id, 1024, 512, losses,
                         gt_path=gt_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if kind == "cuboid":
            print(" Testing Result ".center(50, "="))
            print("Corner Error (%):", np.mean(losses["CE"]))
            print("Pixel  Error (%):", np.mean(losses["PE"]))
            print("3DIoU        (%):", np.mean(losses["3DIoU"]))
            print("=" * 50)
        else:
            summarize_general(losses)
    return out.getvalue(), per_pano


def _trace_check(trace_dir, spans, name):
    """The Chrome trace in trace_dir: it parses, holds ``spans``; returns
    the number of its K1 kernel events (recurrence_bf16/f32)."""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(paths) == 1, f"{name}: {len(paths)} traces in {trace_dir}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    check(spans <= names, f"{name}: spans {sorted(spans - names)} missing "
          "from the trace")
    kernels = [str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel"]
    k1 = [k for k in kernels if "recurrence_" in k]
    log(f"{name}: {len(kernels)} kernel events in the trace"
        + (f", K1 as {k1[0][:80]!r}" if k1 else ""))
    return len(k1)


def phase_eval(state):
    """The eval flow on the card: the inference CLI on rolled copies of the
    golden pano, the eval CLIs against in-process metrics, --profile_dir
    traces, layout_viewer, dataset_vis and trace_serving."""
    import contextlib
    import io

    import numpy as np
    from horizonnet_tpu_torch.cli import dataset_vis, layout_viewer
    from horizonnet_tpu_torch.data import dataset as ds_mod
    from horizonnet_tpu_torch.evals import test_cuboid
    from horizonnet_tpu_torch.utils.image import read_png, write_png

    card = state["card"]
    img, want = _golden_inputs()
    gt = np.loadtxt(os.path.join(GOLDEN, "val_room_cor.txt"))
    gt_cuboid = _plan_box_cuboid(gt)
    rolls = [0] + [int(r) for r in
                   np.random.default_rng(1).integers(1, 1024, EVAL_N - 1)]
    env = dict(os.environ, PYTHONPATH=REPO, NVIDIA_TF32_OVERRIDE="0")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        def sub(*parts):
            return os.path.join(d, *parts)

        for name in ("img", "gt_cuboid", "gt_general"):
            os.makedirs(sub(name))
        for i, r in enumerate(rolls):
            write_png(sub("img", f"p{i:02d}.png"), np.roll(img, r, axis=1))
            for name, cor in (("gt_cuboid", gt_cuboid), ("gt_general", gt)):
                np.savetxt(sub(name, f"p{i:02d}.txt"), _rolled_cor(cor, r),
                           fmt="%.4f")

        # the inference CLI on the card: the host postprocess, f32, TF32 off
        base = ["--pth", os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt"),
                "--img_glob", sub("img", "*.png"), "--device", "cuda"]
        wall = {}
        for mode, extra in (("cuboid", ["--force_cuboid"]), ("general", [])):
            wall[mode], n = _cli_counted(
                base + extra + ["--output_dir", sub(f"out_{mode}")], env)
            launches += n
            check(len(os.listdir(sub(f"out_{mode}"))) == EVAL_N,
                  f"inference CLI {mode} wrote "
                  f"{len(os.listdir(sub(f'out_{mode}')))} JSONs")
        log(f"eval inference CLI (resnet18_rnn golden ckpt, f32, TF32 off, "
            f"host postprocess, {EVAL_N} panos, process start included): "
            f"cuboid {wall['cuboid']:.2f} s, general {wall['general']:.2f} "
            f"s; K1 launches {launches}")
        note(state, cli_s=wall)

        # the eval CLIs against the metrics computed in this process
        for cli, mode, gt_dir in (("eval_cuboid", "cuboid", "gt_cuboid"),
                                  ("eval_general", "general", "gt_general"),
                                  ("eval_general", "cuboid", "gt_general")):
            dt_glob, gt_glob = sub(f"out_{mode}", "*.json"), sub(gt_dir,
                                                                 "*.txt")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"horizonnet_tpu_torch.cli.{cli}",
                 "--dt_glob", dt_glob, "--gt_glob", gt_glob], cwd=REPO,
                env=env, capture_output=True, text=True, timeout=600)
            t_cli = time.perf_counter() - t0
            check(proc.returncode == 0, f"{cli} failed ({proc.returncode}):"
                  f"\n{proc.stderr[-4000:]}")
            t0 = time.perf_counter()
            kind = "cuboid" if cli == "eval_cuboid" else "general"
            here, per_pano = _eval_stdout(kind, dt_glob, gt_glob)
            t_here = time.perf_counter() - t0
            check(proc.stdout == here, f"{cli} on {mode} printed another "
                  f"result than in-process:\n{proc.stdout}\n{here}")
            check("nan" not in here.lower(), f"{cli} on {mode}: {here}")
            log(f"{cli} on the card's {mode} JSONs against {gt_dir} "
                f"(equal to in-process, to print precision):")
            for line in here.strip().splitlines():
                log(f"  {line}")
            log(f"{cli}: {t_cli / EVAL_N:.4f} s a pano through the CLI "
                f"(process start included), {t_here / EVAL_N * 1e3:.2f} ms "
                f"a pano in-process [{card}]")
            note(state, **{f"{cli}_{mode}_s_a_pano": t_cli / EVAL_N})
            if cli == "eval_cuboid":
                cpu = {"CE": [], "PE": [], "3DIoU": []}
                test_cuboid((want["cuboid_uv"] * [1024, 512]).astype(
                    np.float32), 50.0, float(want["cuboid_z1"]),
                    gt_cuboid.astype(np.float32), 1024, 512, cpu)
                diff = abs(per_pano[0] - cpu["3DIoU"][0])
                log(f"golden pano 3DIoU against its cuboid label: card "
                    f"{per_pano[0]:.4f}, CPU golden_outputs.npz "
                    f"{cpu['3DIoU'][0]:.4f} ({diff:.4f} points apart; bar "
                    "2.0); rolled copies "
                    f"{min(per_pano):.4f}-{max(per_pano):.4f}")
                check(diff < 2.0, f"golden 3DIoU {per_pano[0]} is {diff} "
                      f"points from the CPU's {cpu['3DIoU'][0]}")
                note(state, golden_3diou=[per_pano[0], cpu["3DIoU"][0]])

        # --profile_dir: the host path (cuboid) and the device postprocess
        # (general, the tail on serve_stream's worker threads)
        prof_wall = {}
        for name, extra, spans in (
                ("cuboid", ["--force_cuboid"],
                 {"serve/ingest", "serve/forward+postproc"}),
                ("device_postproc general", ["--device_postproc"],
                 {"serve/ingest", "serve/general_finish"})):
            for attempt in range(3):
                trace = sub(f"trace_{len(prof_wall)}_{attempt}")
                t, n = _cli_counted(base + extra + [
                    "--output_dir", sub(f"prof_{len(prof_wall)}"),
                    "--profile_dir", trace], env)
                launches += n
                k1 = _trace_check(trace, spans, f"--profile_dir {name}")
                log(f"--profile_dir {name}: spans {sorted(spans)} present, "
                    f"{k1} K1 kernel events for {n} launches ({t:.2f} s)")
                if k1:
                    break
            check(k1 > 0, f"--profile_dir {name}: 3 traces without a K1 "
                  "kernel event")
            prof_wall[name] = t
        log(f"inference CLI wall with the profiler {prof_wall['cuboid']:.2f}"
            f" s against {wall['cuboid']:.2f} s without (cuboid, host path, "
            f"{EVAL_N} panos, process start included) [{card}]")
        note(state, profiler_cli_s=prof_wall)

        # layout_viewer on the card's cuboid JSON and on the CPU's
        counts = {}
        for name, path in (("card", sub("out_cuboid", "p00.json")),
                           ("cpu", sub("cpu.json"))):
            if name == "cpu":
                with open(path, "w") as f:
                    json.dump({"z0": 50.0, "z1": float(want["cuboid_z1"]),
                               "uv": want["cuboid_uv"].tolist()}, f)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                check(layout_viewer.main(
                    ["--img", sub("img", "p00.png"), "--layout", path,
                     "--out", sub(f"{name}.ply"), "--html",
                     sub(f"{name}.html"), "--vis_out",
                     sub(f"{name}.png")]) == 0, "layout_viewer failed")
            with open(sub(f"{name}.ply")) as f:
                head = [next(f) for _ in range(12)]
            counts[name] = [line.strip() for line in head
                            if line.startswith("element ")]
        check(counts["card"] == counts["cpu"] and len(counts["card"]) == 2,
              f"layout_viewer PLY counts {counts}")
        with open(sub("card.html")) as f:
            check("<canvas" in f.read(), "layout_viewer HTML has no canvas")
        preview = read_png(sub("card.png"))
        check(preview.shape == (480, 2560, 3), f"preview {preview.shape}")
        log(f"layout_viewer: PLY {counts['card']} (the CPU JSON's too), "
            "HTML with a canvas, preview 2560x480")

        # dataset_vis: without augmentation the card run's strips equal the
        # CPU run's; with it the warp runs on the card
        _write_rooms(sub("rooms"), 2)
        warped_on = []
        augment_batch = ds_mod.augment_batch

        def spy(*a, **kw):
            x = augment_batch(*a, **kw)
            warped_on.append(x[0].device.type)
            return x

        for name, extra in (("cpu", ["--device", "cpu"]),
                            ("card", ["--device", "cuda"]),
                            ("card_aug", ["--device", "cuda", "--flip",
                                          "--rotate", "--gamma",
                                          "--stretch"])):
            ds_mod.augment_batch = spy
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    check(dataset_vis.main(
                        ["--root_dir", sub("rooms"), "--ith", "-1",
                         "--out_dir", sub(f"vis_{name}"), *extra]) == 0,
                        f"dataset_vis {name} failed")
            finally:
                ds_mod.augment_batch = augment_batch
        for i in range(2):
            strips = {n: read_png(sub(f"vis_{n}", f"room{i}.png"))
                      for n in ("cpu", "card", "card_aug")}
            check(np.array_equal(strips["cpu"], strips["card"]),
                  f"dataset_vis room{i}: the card's strip differs from the "
                  "CPU's")
            aug = strips["card_aug"]
            check(aug.shape == (33 + 512, 1024, 3) and aug.dtype == np.uint8
                  and aug.std() > 0, f"dataset_vis room{i} augmented: "
                  f"{aug.shape} {aug.dtype}")
        check(warped_on == ["cuda", "cuda"], f"dataset_vis warps ran on "
              f"{warped_on}, not the card")
        log("dataset_vis: strips equal to the CPU run's; with --flip "
            "--rotate --gamma --stretch the warp ran on the card")

    # trace_serving: the flagship's batch by kernel
    tool = os.path.join(REPO, "horizonnet_tpu_torch", "tools",
                        "trace_serving.py")
    for attempt in range(3):
        proc = subprocess.run([sys.executable, tool, "64", "dct4", "cuboid",
                               "12"], cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, f"trace_serving failed "
              f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        summary = json.loads(lines[-1])
        k1 = {k: v for k, v in summary["kernels"].items()
              if "recurrence_" in k}
        if k1:
            break
        log(f"trace_serving try {attempt + 1}: no K1 kernel recorded")
    check(bool(k1), "trace_serving: 3 profiles without K1 among the kernels")
    log(f"trace_serving 64 dct4 cuboid 12 [{card}]:")
    for line in lines[:-1]:
        log(f"  {line}")
    log(f"trace_serving: device busy {100 * summary['busy_share']:.1f} % of "
        f"the batch's {summary['span_ms']:.3f} ms span; K1 "
        + ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in k1.items()))
    note(state, trace_busy=summary["busy_share"],
         trace_span_ms=summary["span_ms"], trace_k1_ms=sum(k1.values()),
         trace_top=sorted(([v, k[:40]] for k, v in
                           summary["kernels"].items()), reverse=True)[:6])
    _launched(state, "bilstm_fwd", "eval", launches)


# The parallel phase's two-rank layouts and its bars against one process
# on the card, per compute dtype (float32 with TF32 off; bf16 on float32
# parameters): losses relative; the L2 norm of the gathered gradient's
# difference over one process's, per tensor for the bi-LSTM and head and
# for the conv stacks (tests/test_torch_parallel.py's measure), and over
# the whole model (the height stage's conv biases, zero in exact
# arithmetic under batch norm, left out); running statistics within a
# share of each tensor's largest entry. bf16 holds the whole gradient
# only, against its own rounding: the one-process bf16 step's distance
# from the one-process float32 step, times PAR_BF16_X (two steps that
# each carry bf16's rounding lie about sqrt(2) of it apart; a tensor whose
# sums cancel is rounding noise in bf16).
# The parameters after one Adam step at PAR_LR must lie within one step of
# one process's (every entry moves by about lr); the share that moved the
# other way (their gradient took the other sign) is printed: in bf16 it
# counts every entry whose gradient is below the rounding noise.
PAR_LAYOUTS = ((2, 1), (1, 2))
PAR_LR = 1e-4
PAR_BARS = {
    "float32": dict(loss=1e-5, grad_head=1e-4, grad_conv=5e-2, grad_all=5e-2,
                    stats=1e-4),
    "bfloat16": dict(loss=1e-2, grad_head=None, grad_conv=None,
                     grad_all=None, stats=5e-2)}
PAR_BF16_X = 2.0
# the torchrun run's first two losses against the same CLI run without
# torchrun: the first step is the same forward (bf16), the second follows
# an update from cuDNN's backward, which is not bit-reproducible
PAR_CLI_BARS = (1e-3, 1e-2)
# rows of the data-parallel flagship that must land within 2 px of the
# one-process engine's: bf16 heatmaps have exact ties between columns,
# broken by sums in another order at another local batch
PAR_FLAGSHIP_ROWS = 56


def _train_cli_counted(cli_args, torchrun, cwd):
    """python -m horizonnet_tpu_torch.cli.train ``cli_args`` (runpy runs
    the module as __main__, as -m does) from ``cwd``, under torchrun on
    one process (--standalone, NCCL) or alone, in fresh processes that
    report at exit K2's and K3's launches and every step's loss:
    (seconds, K2, K3, losses, stdout). torchrun's parser reads an
    argument of the script that abbreviates one of its own options as
    that option (torch 2.11 refused ``--logs``, a prefix of its
    ``--logs-specs``), so pass none: ``--logs`` keeps its default under
    ``cwd``."""
    code = "\n".join([
        "import json, runpy, sys",
        "from horizonnet_tpu_torch.ops import cuda_lstm_train as clt",
        "from horizonnet_tpu_torch.train import engine",
        "losses, step = [], engine.TrainEngine.step",
        "def counted(self, *args):",
        "    m = step(self, *args)",
        "    losses.append(m['total'].item())",
        "    return m",
        "engine.TrainEngine.step = counted",
        "try:",
        "    runpy.run_module('horizonnet_tpu_torch.cli.train', "
        "run_name='__main__', alter_sys=True)",
        "finally:",
        "    print('TRAIN_COUNTS ' + json.dumps([clt.fwd_launches, "
        "clt.bwd_launches, losses]), file=sys.stderr)"])
    cmd = [sys.executable, "-c", code, *cli_args]
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "--no_python", *cmd]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"train CLI (torchrun {torchrun}) failed "
          f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    found = [json.loads(line.split(" ", 1)[1])
             for line in proc.stderr.splitlines()
             if line.startswith("TRAIN_COUNTS ")]
    check(len(found) == 1, "the train CLI did not report its counts")
    k2, k3, losses = found[0]
    return dt, k2, k3, losses, proc.stdout


def _par_train_setup(dtype, mesh=None):
    """The two-rank check's train step: resnet50_rnn at 512x1024, ``dtype``
    compute on float32 parameters, K2/K3, Adam at PAR_LR, random weights
    from seed 0, a global batch of TRAIN_B from numpy seed 0 and the
    dropout generator seeded 0 (on every rank): (engine, global batch,
    generator). The engine steps eagerly, with a mesh or without: the
    one-process reference is the program the layouts run (its batch norms
    may be given a process group after it is built)."""
    import numpy as np
    import torch
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)

    B, H, W = TRAIN_B, 512, 1024
    model = build_model("resnet50", True, device="cuda", dtype=dtype,
                        lstm_impl="kernel_train", param_dtype=torch.float32,
                        seed=0)
    st = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(PAR_LR, 1000)))
    eng = TrainEngine(model, st, B, H, W, device="cuda", mesh=mesh,
                      graph=False)
    rng = np.random.default_rng(0)
    batch = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             rng.normal(0, 0.5, (B, 2, W)).astype(np.float32),
             rng.uniform(0, 1, (B, 1, W)).astype(np.float32))
    return eng, batch, torch.Generator(device="cuda").manual_seed(0)


def _step_ms(eng, batch, gen, n=3):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step(*batch, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _par_step(eng, batch, gen):
    """One step: (losses, {name: gathered gradient}, {name: gathered
    state}), float32 on the host."""
    m = eng.step(*batch, gen)
    grads = eng.full({k: p.grad for k, p in eng.model.named_parameters()})
    return ([m[k].item() for k in ("total", "bon", "cor")],
            {k: v.float().cpu() for k, v in grads.items()},
            {k: v.float().clone() for k, v in
             eng.host_state()["state_dict"].items()
             if not k.endswith("num_batches_tracked")})


def _par_compare(got, ref):
    """The bars' measures of a step (``_par_step``) against another's,
    ``ref``."""
    (losses, grads, sd), (r_losses, r_grads, r_sd) = got, ref
    out = dict(losses=losses, loss=max(abs(a - b) / abs(b)
                                       for a, b in zip(losses, r_losses)),
               grad_head=(0.0, ""), grad_conv=(0.0, ""), stats=0.0,
               max_d=0.0)
    n_all = n_flip = 0
    sq_diff = sq_ref = 0.0
    for k, r in r_sd.items():
        d = (sd[k] - r).abs()
        if k not in r_grads:   # the running statistics
            out["stats"] = max(out["stats"], float(d.max() / r.abs().max()))
            continue
        out["max_d"] = max(out["max_d"], float(d.max()))
        n_all, n_flip = n_all + d.numel(), n_flip + int((d > PAR_LR).sum())
        if k.startswith("reduce_height_module.") and \
                k.endswith(".layers.0.1.bias"):
            continue
        diff, norm = (grads[k] - r_grads[k]).norm(), r_grads[k].norm()
        sq_diff, sq_ref = sq_diff + float(diff) ** 2, sq_ref + float(norm) ** 2
        err = float(diff / norm)
        key = ("grad_head" if k.startswith(("bi_rnn.", "linear."))
               else "grad_conv")
        out[key] = max(out[key], (err, k))
    out["flip"] = n_flip / n_all
    out["grad_all"] = (sq_diff / sq_ref) ** 0.5
    return out


def _par_train_rank(ref_path, layouts):
    """One rank of the parallel phase's train check: for each compute dtype
    and layout, the first step against one process's (``ref_path``),
    K2/K3's launches, the encoder's parameter bytes here and whole, and
    ms a step."""
    import torch
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt
    from horizonnet_tpu_torch.parallel import make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = torch.load(ref_path, weights_only=False)
    out = []
    for name, ref in refs.items():
        for n_data, n_model in layouts:
            mesh = make_mesh(n_data, n_model)
            eng, batch, gen = _par_train_setup(getattr(torch, name), mesh)
            batch = shard_batch(mesh, batch)
            clt.fwd_launches = clt.bwd_launches = 0
            res = _par_compare(_par_step(eng, batch, gen), ref)
            enc = [k for k, _ in eng.model.named_parameters()
                   if k.startswith("feature_extractor.encoder.")]
            local = eng.model.state_dict()
            res.update(dtype=name, layout=(n_data, n_model),
                       k2=clt.fwd_launches, k3=clt.bwd_launches,
                       enc_local=sum(local[k].numel() * 4 for k in enc),
                       enc_whole=sum(ref[2][k].numel() * 4 for k in enc),
                       ms=_step_ms(eng, batch, gen, n=1))
            out.append(res)
            del eng
            torch.cuda.empty_cache()
    return out


def _par_serve_rank(wire_path):
    """One rank of the parallel phase's serving check over a (2, 1) mesh:
    the golden f32 (TF32 off) in cuboid and general mode, val_room in
    both rows of a batch of 2; the flagship (resnet50_rnn bf16, dct4,
    cuboid) on ``wire_path``'s batch; K1's launches."""
    import numpy as np
    import torch
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.ops import cuda_lstm
    from horizonnet_tpu_torch.parallel import make_mesh
    from horizonnet_tpu_torch.postproc import (finish_general_batch,
                                               unpack_cuboid_outputs)
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2, 1)
    cuda_lstm.launches = 0
    img, _ = _golden_inputs()
    x = np.repeat(img[None].astype(np.float32) / 255.0, 2, 0)
    model, sd = load_trained_model(
        os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt"), device="cuda")
    golden = []
    for postproc in ("cuboid", "general"):
        eng = InferenceEngine(model, sd, 2, postproc=postproc,
                              device="cuda", mesh=mesh)
        golden.append(eng(x))
    cuboid = unpack_cuboid_outputs(golden[0])
    general = finish_general_batch(golden[1])
    eng = _flagship_engine("cuboid", mesh=mesh)
    wire = np.load(wire_path)
    cor_id, z1 = unpack_cuboid_outputs(eng(wire))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng(wire)
    torch.cuda.synchronize()
    return dict(cuboid=cuboid, general=general, flagship=(cor_id, z1),
                ms=(time.perf_counter() - t0) / 3 * 1e3,
                k1=cuda_lstm.launches)


def phase_parallel(state):
    import numpy as np
    import torch
    from horizonnet_tpu_torch.parallel.dryrun import run_ranks
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    card = state["card"]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        # 1. the train CLI under torchrun, one rank on NCCL, against the
        # same run without torchrun
        _write_rooms(os.path.join(root, "rooms"), 2 * TRAIN_B)
        runs = {}
        for name, torchrun in (("torchrun", True), ("alone", False)):
            runs[name] = _train_cli_counted(
                ["--id", name, "--ckpt", os.path.join(root, "ckpt"),
                 "--train_root_dir", os.path.join(root, "rooms"),
                 "--valid_root_dir", "",
                 "--backbone", "resnet50", "--batch_size_train",
                 str(TRAIN_B), "--epochs", "1", "--save_every", "1",
                 "--lstm_impl", "pallas_train", "--bf16", "--device",
                 "cuda"], torchrun, root)
        dt, k2, k3, losses, stdout = runs["torchrun"]
        check("backend nccl" in stdout, f"torchrun's rank did not take "
              f"NCCL:\n{stdout[-2000:]}")
        _launched(state, "bilstm_train_fwd", "parallel_torchrun", k2)
        _launched(state, "bilstm_bwd", "parallel_torchrun", k3)
        alone = runs["alone"][3]
        check(len(losses) == len(alone) == 2, f"losses {losses}, {alone}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, alone)]
        check(all(r <= bar for r, bar in zip(rel, PAR_CLI_BARS)),
              f"torchrun's losses {losses} against {alone}")
        _, sd = load_trained_model(os.path.join(root, "ckpt", "torchrun",
                                                "epoch_1.ckpt"),
                                   device="cuda")
        check(all(bool(torch.isfinite(v.float()).all()) for v in sd.values()),
              "torchrun's epoch_1.ckpt is not finite")
        log(f"parallel torchrun: train CLI, resnet50 bf16 B={TRAIN_B} "
            f"512x1024, one rank on NCCL ([dist] line: "
            f"{[ln for ln in stdout.splitlines() if '[dist]' in ln]}), 2 "
            f"steps in {dt:.1f} s (process and build included; "
            f"{runs['alone'][0]:.1f} s alone): losses {losses} against "
            f"{alone} without torchrun (relative {rel[0]:.2e}, "
            f"{rel[1]:.2e}; bars {PAR_CLI_BARS}), K2 {k2}, K3 {k3} "
            f"launches; epoch_1.ckpt loads, finite [{card}]")
        note(state, torchrun_loss_rel=rel)

        # 2. two ranks sharing the card (gloo) at each layout against one
        # process on the card, in float32 and in bf16
        refs, one_ms = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            eng, batch, gen = _par_train_setup(dtype)
            refs[name] = _par_step(eng, batch, gen)
            one_ms[name] = _step_ms(eng, batch, gen)
            del eng
            torch.cuda.empty_cache()
        bf16_noise = _par_compare(refs["bfloat16"], refs["float32"])
        bars = dict(PAR_BARS)
        bars["bfloat16"] = dict(bars["bfloat16"],
                                grad_all=PAR_BF16_X * bf16_noise["grad_all"])
        log(f"parallel train, one process: bf16's gradient "
            f"{bf16_noise['grad_all']:.3e} from float32's over the whole "
            f"model, losses {bf16_noise['losses']} against "
            f"{refs['float32'][0]} [{card}]")
        note(state, bf16_from_f32=bf16_noise["grad_all"])
        ref_path = os.path.join(root, "ref.pt")
        torch.save(refs, ref_path)
        t0 = time.perf_counter()
        ranks = run_ranks(_par_train_rank, 2, ref_path, PAR_LAYOUTS,
                          device="cuda", timeout=600)
        t_ranks = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            for lay in res:
                check(lay["k2"] > 0 and lay["k3"] > 0, f"rank {r} at "
                      f"{lay['layout']}: K2 {lay['k2']}, K3 {lay['k3']}")
        _launched(state, "bilstm_train_fwd", "parallel_ranks",
                  sum(lay["k2"] for res in ranks for lay in res))
        _launched(state, "bilstm_bwd", "parallel_ranks",
                  sum(lay["k3"] for res in ranks for lay in res))
        for i, lay in enumerate(ranks[0]):
            bar = bars[lay["dtype"]]
            share = lay["enc_local"] / lay["enc_whole"]
            log(f"parallel train {lay['dtype']} layout (data="
                f"{lay['layout'][0]}, model={lay['layout'][1]}), two ranks "
                f"sharing one card over gloo (not a multi-GPU speed), "
                f"against one process: losses {lay['losses']} (relative "
                f"{lay['loss']:.2e}, bar {bar['loss']}); gradients: whole "
                f"model {lay['grad_all']:.2e} (bar {bar['grad_all']}), "
                f"worst tensor of the bi-LSTM and head "
                f"{lay['grad_head'][0]:.2e} ({lay['grad_head'][1]}; bar "
                f"{bar['grad_head']}), of the conv stacks "
                f"{lay['grad_conv'][0]:.2e} ({lay['grad_conv'][1]}; bar "
                f"{bar['grad_conv']}); running statistics "
                f"{lay['stats']:.2e} (bar {bar['stats']}); parameters "
                f"after one Adam step: max |d| {lay['max_d']:.4e} (one step "
                f"{PAR_LR}), {100 * lay['flip']:.3f} % moved the other way; "
                f"encoder parameters here {lay['enc_local'] / 2**20:.1f} of "
                f"{lay['enc_whole'] / 2**20:.1f} MiB ({share:.3f}); K2/K3 "
                f"launches on ranks 0, 1: "
                f"{[(res[i]['k2'], res[i]['k3']) for res in ranks]}; "
                f"{lay['ms']:.1f} ms a step against one process's "
                f"{one_ms[lay['dtype']]:.1f} [{card}]")
            note(state, **{f"{lay['dtype']}_{lay['layout'][0]}"
                           f"{lay['layout'][1]}": dict(
                               loss=lay["loss"], grad_all=lay["grad_all"],
                               grad_conv=lay["grad_conv"][0],
                               grad_head=lay["grad_head"][0],
                               stats=lay["stats"], flip=lay["flip"],
                               enc_share=share, ms=lay["ms"],
                               one_ms=one_ms[lay["dtype"]])})
        log(f"parallel train: both dtypes and layouts in {t_ranks:.1f} s "
            "(spawn, builds and steps)")

        # 3. data-parallel serving, two ranks
        wire = _flagship_wire(state)[0]
        wire_path = os.path.join(root, "wire.npy")
        np.save(wire_path, wire)
        one = unpack_cuboid_outputs(_flagship_engine("cuboid")(wire))
        img, want = _golden_inputs()
        t0 = time.perf_counter()
        serve = run_ranks(_par_serve_rank, 2, wire_path, device="cuda",
                          timeout=600)
        t_serve = time.perf_counter() - t0
    for r, res in enumerate(serve):
        cid, z1 = res["cuboid"]
        dpx = float(np.abs(cid - want["cuboid_uv"]).max() * 512)
        gpx = max(float(np.abs(c - want["general_uv"]).max() * 512)
                  if c.shape == want["general_uv"].shape else np.inf
                  for c, _, _ in res["general"])
        f_cid, f_z1 = res["flagship"]
        check(f_cid.shape == (FLAGSHIP_B, 8, 2) and
              bool(np.isfinite(f_cid).all() and np.isfinite(f_z1).all()),
              f"rank {r}: flagship {f_cid.shape} not finite")
        rows = np.abs(f_cid - one[0]).max(axis=(1, 2)) * 512
        same = int((rows < 2.0).sum())
        log(f"parallel serving rank {r} (data=2, two ranks on one card): "
            f"golden f32 cuboid {dpx:.4f} px, general {gpx:.4f} px from "
            f"golden_outputs.npz (both rows); flagship {f_cid.shape}, "
            f"{same} of {FLAGSHIP_B} rows within 2 px of the one-process "
            f"engine's (worst {rows.max():.1f} px; bar "
            f"{PAR_FLAGSHIP_ROWS}), {res['ms']:.1f} ms a batch of "
            f"{FLAGSHIP_B}; K1 launches {res['k1']} [{card}]")
        note(state, **{f"serving_rank{r}": dict(
            golden_px=[dpx, gpx], rows=same, worst_px=float(rows.max()),
            ms=res["ms"])})
        check(dpx < 2.0 and gpx < 2.0, f"rank {r}: golden off by {dpx}, "
              f"{gpx} px")
        check(same >= PAR_FLAGSHIP_ROWS, f"rank {r}: {same} flagship rows")
        check(res["k1"] > 0, f"rank {r}: K1 was not launched")
        check(np.array_equal(f_cid, serve[0]["flagship"][0]),
              "the ranks returned different flagship results")
    _launched(state, "bilstm_fwd", "parallel_serving",
              sum(res["k1"] for res in serve))
    log(f"parallel serving: {t_serve:.1f} s (spawn, builds, serving)")
    for lay in ranks[0]:   # checked after the serving part
        bar, what = bars[lay["dtype"]], (lay["dtype"], lay["layout"])
        for key in ("loss", "grad_all", "stats"):
            check(lay[key] <= bar[key], f"{what}: {key}")
        for key in ("grad_head", "grad_conv"):
            check(bar[key] is None or lay[key][0] <= bar[key],
                  f"{what}: {key}")
        # two opposite steps, and float32's rounding of parameters
        # up to 8 in size
        check(lay["max_d"] <= 2.01 * PAR_LR, f"{what}: a parameter "
              "moved by more than one step from one process's")
        if lay["layout"][1] == 2:
            share = lay["enc_local"] / lay["enc_whole"]
            check(abs(share - 0.5) < 0.01, f"encoder share {share}")


# The bench phase: the port's throughput entry points in fresh processes,
# each printing its JSON line last
BENCH_ENV = {"BENCH_REPS": "3", "BENCH_E2E_N": "32"}
TRAIN_TOOL = os.path.join(REPO, "horizonnet_tpu_torch", "tools",
                          "train_throughput.py")
TRAIN_ARGS = ("10", "24", "resnet50", "bf16", "pallas_train")
# bench.py's numbers (the JAX package's line), and the port's train line's
BENCH_NUMBERS = (
    "value", "vs_baseline", "reps_panos_per_sec", "warmup_rep_panos_per_sec",
    "reps_spread_pct", "ingest_mb_per_s", "best_panos_per_sec",
    "device_panos_per_sec", "serving_mfu_pct", "fwd_gflops_per_pano",
    "e2e_panos_per_sec", "e2e_vs_baseline", "e2e_vs_baseline_gpu_adj",
    "ref_e2e_panos_per_sec", "ref_e2e_gpu_adj_panos_per_sec", "e2e_workers",
    "preprocess_s_per_pano", "wire_bytes_per_pano", "baseline_panos_per_sec",
    "peak_flops")
TRAIN_NUMBERS = ("ms_per_step", "panos_per_sec", "train_mfu_pct",
                 "step_gflops", "peak_flops", "peak_mem_gib", "losses")


def _json_lines(cmd, env, what):
    """Run ``cmd`` from the checkout: (seconds, its stdout's JSON lines,
    its other stdout lines)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} failed ({proc.returncode}):\n"
          f"{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    found = [json.loads(ln) for ln in lines if ln.startswith("{")]
    check(found and lines[-1].startswith("{"),
          f"{what} did not print its JSON line last")
    return dt, found, [ln for ln in lines if not ln.startswith("{")]


def _finite_numbers(rec, keys, what):
    for k in keys:
        v = rec.get(k)
        vals = (list(v.values()) if isinstance(v, dict) else
                v if isinstance(v, list) else [v])
        check(bool(vals) and all(isinstance(x, (int, float))
                                 and math.isfinite(x) for x in vals),
              f"{what}: {k} = {v!r}, not finite numbers")


def phase_bench(state):
    import torch

    card = state["card"]
    torch.cuda.empty_cache()   # the card's memory to the fresh processes
    env = dict(os.environ, PYTHONPATH=REPO, **BENCH_ENV)
    dt_b, lines, _ = _json_lines(
        [sys.executable, "-m", "horizonnet_tpu_torch.bench"], env, "bench")
    rec = lines[-1]
    check(len(lines) == 2 and lines[0].get("provisional") is True
          and lines[0]["e2e_panos_per_sec"] is None
          and "provisional" not in rec,
          "bench printed no provisional line before its whole line")
    _finite_numbers(rec, BENCH_NUMBERS, "bench")
    check(all(k in rec for k in ("metric", "unit", "config", "device")),
          "bench: a key of the line is missing")
    check(rec["device"] == torch.cuda.get_device_name(0),
          f"bench ran on {rec['device']}")
    check(0 < rec["serving_mfu_pct"] <= 100,
          f"serving MFU {rec['serving_mfu_pct']} %")
    _launched(state, "bilstm_fwd", "bench",
              rec["kernel_launches"]["cuda_lstm.launches"])
    log(f"bench (python -m horizonnet_tpu_torch.bench, "
        f"{' '.join(f'{k}={v}' for k, v in BENCH_ENV.items())}), "
        f"{dt_b:.1f} s with the process start [{card}]: {json.dumps(rec)}")
    if "flagship_device" in state:
        ratio = rec["device_panos_per_sec"] / state["flagship_device"]
        log(f"bench device panos/s {rec['device_panos_per_sec']} against "
            f"the flagship phase's captured {state['flagship_device']:.2f}"
            f" (ratio {ratio:.4f}; within 10 %)")
        check(abs(ratio - 1) <= 0.10, f"bench's device rate is {ratio:.3f}"
              " of the flagship phase's")
    note(state, bench={k: rec[k] for k in (
        "value", "reps_panos_per_sec", "warmup_rep_panos_per_sec",
        "device_panos_per_sec", "serving_mfu_pct", "fwd_gflops_per_pano",
        "e2e_panos_per_sec", "e2e_vs_baseline", "e2e_vs_baseline_gpu_adj",
        "e2e_no_vp", "preprocess_s_per_pano", "ingest_mb_per_s")},
        bench_s=dt_b)

    torch.cuda.empty_cache()
    dt_t, lines, text = _json_lines([sys.executable, TRAIN_TOOL, *TRAIN_ARGS],
                                    dict(os.environ, PYTHONPATH=REPO),
                                    "train_throughput")
    trec = lines[-1]
    _finite_numbers(trec, TRAIN_NUMBERS, "train_throughput")
    check(0 < trec["train_mfu_pct"] <= 100,
          f"train MFU {trec['train_mfu_pct']} %")
    counts = trec["kernel_launches"]
    _launched(state, "bilstm_train_fwd", "train_throughput",
              counts["cuda_lstm_train.fwd_launches"])
    _launched(state, "bilstm_bwd", "train_throughput",
              counts["cuda_lstm_train.bwd_launches"])
    log(f"train_throughput {' '.join(TRAIN_ARGS)}, {dt_t:.1f} s with the "
        f"process start [{card}]:\n" + "\n".join(text) + f"\n{json.dumps(trec)}")
    note(state, train={k: trec[k] for k in (
        "ms_per_step", "train_mfu_pct", "step_gflops", "peak_mem_gib")},
        train_s=dt_t)



# The parity phase: the weights-parity harness on the card (golden f32 with
# TF32 off against the CPU, within PARITY_TOL of every metric; then
# resnet50_rnn at full width through --need_preprocess)
PARITY_N = 16
PARITY_TOL = 0.01
PARITY_TOOL = os.path.join(REPO, "horizonnet_tpu_torch", "tools",
                           "parity_eval.py")


def _parity_tool():
    """horizonnet_tpu_torch/tools/parity_eval.py as a module (a script, not
    a package module), for its eval functions."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("parity_eval", PARITY_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parity_counted(args, env):
    """``python3 horizonnet_tpu_torch/tools/parity_eval.py args`` in a fresh
    process that reports at exit K1's launch count, from 0, and the
    seconds of its stages: VP alignment (the preprocess CLI's main),
    inference (the inference CLI's main, model load included) and what
    follows (the eval and the verdict). Returns (stages and K1 launches,
    stdout); the exit code must be 0."""
    code = "\n".join([
        "import json, runpy, sys, time",
        "from horizonnet_tpu_torch.cli import inference, preprocess",
        "from horizonnet_tpu_torch.ops import cuda_lstm",
        "rep = {'pre_s': 0.0, 'infer_s': 0.0}",
        "def timed(mod, key):",
        "    main = mod.main",
        "    def run(argv):",
        "        t0 = time.perf_counter()",
        "        try:",
        "            return main(argv)",
        "        finally:",
        "            rep['t_end'] = time.perf_counter()",
        "            rep[key] = rep['t_end'] - t0",
        "    mod.main = run",
        "timed(preprocess, 'pre_s')",
        "timed(inference, 'infer_s')",
        "try:",
        f"    runpy.run_path({PARITY_TOOL!r}, run_name='__main__')",
        "finally:",
        "    t_end = rep.pop('t_end', time.perf_counter())",
        "    rep.update(k1=cuda_lstm.launches, "
        "eval_s=time.perf_counter() - t_end)",
        "    print('PARITY_RUN ' + json.dumps(rep), file=sys.stderr)"])
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"parity_eval {args[-6:]} exited "
          f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    found = [json.loads(line.split(" ", 1)[1])
             for line in proc.stderr.splitlines()
             if line.startswith("PARITY_RUN ")]
    check(len(found) == 1, "parity_eval did not report its stages")
    return found[0], proc.stdout


def phase_parity(state):
    """tools/parity_eval.py on the card: the golden against the CPU in both
    modes, both verdicts, then resnet50_rnn at full width from a reference
    .pth through VP alignment, bf16 and the device fit."""
    import contextlib
    import io

    import numpy as np
    from horizonnet_tpu_torch.bench import raw_panos
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.utils.image import write_png

    card = state["card"]
    tool = _parity_tool()
    img, _ = _golden_inputs()
    gt = np.loadtxt(os.path.join(GOLDEN, "val_room_cor.txt"))
    box = _plan_box_cuboid(gt)
    gt_dir = {"general": "label_cor", "cuboid": "label_box"}
    rng = np.random.default_rng(1)
    rolls = [0] + [int(r) for r in rng.integers(1, 1024, PARITY_N - 1)]
    ckpt = os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt")
    env = dict(os.environ, PYTHONPATH=REPO)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        def sub(*parts):
            return os.path.join(d, *parts)

        def write_set(name, panos, labels):
            """panos [(pano, roll)] as name/img/pNN.png, and each label of
            ``labels`` ({dir: corners}) rolled the same way into
            name/dir/pNN.txt."""
            for part in ("img", *labels):
                os.makedirs(sub(name, part))
            for i, (pano, r) in enumerate(panos):
                write_png(sub(name, "img", f"p{i:02d}.png"),
                          np.roll(pano, r, axis=1))
                for part, cor in labels.items():
                    np.savetxt(sub(name, part, f"p{i:02d}.txt"),
                               _rolled_cor(cor, r), fmt="%.4f")

        def metrics_of(mode, gt_glob, out):
            evaluate = (tool.eval_cuboid_metrics if mode == "cuboid"
                        else tool.eval_general_metrics)
            with contextlib.redirect_stderr(io.StringIO()):
                return evaluate(gt_glob, os.path.join(out, "dt", "*.json"),
                                1024, 512)

        # 1. the golden, f32 with TF32 off, on the card and on the CPU
        write_set("golden", [(img, r) for r in rolls],
                  {"label_cor": gt, "label_box": box})
        golden_env = dict(env, NVIDIA_TF32_OVERRIDE="0")
        launches, got, walls = 0, {}, {}

        def golden_args(mode, device, out, *extra):
            return ["--pth", ckpt, "--img_glob", sub("golden", "img", "*"),
                    "--gt_glob", sub("golden", gt_dir[mode], "*.txt"),
                    "--dataset", "custom", "--mode", mode, "--output_dir",
                    out, "--device", device, *extra]

        for mode in ("general", "cuboid"):
            for device in ("cuda", "cpu"):
                out = sub(f"golden_{mode}_{device}")
                t0 = time.perf_counter()
                rep, _ = _parity_counted(golden_args(mode, device, out),
                                         golden_env)
                walls[mode, device] = time.perf_counter() - t0
                check((rep["k1"] > 0) == (device == "cuda"),
                      f"parity golden {mode} on {device}: K1 launches "
                      f"{rep['k1']}")
                launches += rep["k1"]
                m, n = metrics_of(mode, sub("golden", gt_dir[mode], "*.txt"),
                                  out)
                check(n == PARITY_N, f"parity golden {mode} on {device}: "
                      f"{n} pairs, not {PARITY_N}")
                check(all(np.isfinite(v) for v in m.values()),
                      f"parity golden {mode} on {device}: {m}")
                got[mode, device] = m
            card_m, cpu_m = got[mode, "cuda"], got[mode, "cpu"]
            diff = max(abs(card_m[k] - cpu_m[k]) for k in cpu_m)
            log(f"parity golden {mode} (resnet18_rnn ckpt, f32, TF32 off, "
                f"{PARITY_N} rolled copies of val_room, host postprocess): "
                f"card {json.dumps(_compact(card_m))}, CPU "
                f"{json.dumps(_compact(cpu_m))}; largest difference "
                f"{diff:.6f} (bar {PARITY_TOL}); wall card "
                f"{walls[mode, 'cuda']:.1f} s, CPU "
                f"{walls[mode, 'cpu']:.1f} s (process start included) "
                f"[{card}]")
            check(diff <= PARITY_TOL, f"parity golden {mode}: the card's "
                  f"metrics {card_m} lie {diff} from the CPU's {cpu_m}")
            note(state, **{f"golden_{mode}_card": card_m,
                           f"golden_{mode}_cpu_diff": diff})

        # both verdicts, in this process on the card: the measured value
        # passes, the measured value + 50 fails
        want3d = got["general", "cuda"]["3DIoU"]
        for shift, rc in ((0.0, 0), (50.0, 2)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                r = tool.main(golden_args(
                    "general", "cuda", sub(f"verdict_{rc}"), "--expect",
                    f"3DIoU={want3d + shift:.4f}"))
            check(r == rc, f"parity verdict at 3DIoU {want3d + shift}: exit "
                  f"{r}, not {rc}")
            check(("PARITY OK" in out.getvalue()) == (rc == 0),
                  f"parity verdict at 3DIoU {want3d + shift}: "
                  f"{out.getvalue()[-500:]}")
        log(f"parity verdicts on the card: --expect 3DIoU={want3d:.4f} exit "
            f"0 (PARITY OK), 3DIoU={want3d + 50:.4f} exit 2")

        # 2. full width: resnet50_rnn, random weights from seed 0 as a
        # reference .pth, raw panos (val_room turned by a known R, rolled)
        # with cuboid labels through --need_preprocess, bf16, the device
        # fit, batch 8
        model = build_model("resnet50", True, device="cpu", seed=0)
        pth = sub("resnet50_rnn.pth")
        _reference_pth(pth, model, model.state_dict())
        del model
        raws = list(raw_panos(img).values())
        write_set("raw", [(raws[i % len(raws)], r)
                          for i, r in enumerate([0] * len(raws) + [
                              int(r) for r in rng.integers(
                                  1, 1024, PARITY_N - len(raws))])],
                  {"label_cor": box})
        out = sub("full")
        rep, stdout = _parity_counted(
            ["--pth", pth, "--root_dir", sub("raw"), "--dataset", "custom",
             "--bf16", "--device_postproc", "--batch_size", "8",
             "--need_preprocess", "--output_dir", out, "--device", "cuda"],
            env)
        n_aligned = len(os.listdir(os.path.join(out, "aligned")))
        m, n = metrics_of("cuboid", sub("raw", "label_cor", "*.txt"), out)
        check(rep["k1"] > 0, "parity full width: K1 was not launched")
        check(n == n_aligned > 0 and all(np.isfinite(v) for v in m.values()),
              f"parity full width: {n} pairs of {n_aligned} aligned, {m}")
        launches += rep["k1"]
        per = {k: rep[f"{k}_s"] / PARITY_N for k in ("pre", "infer", "eval")}
        log(f"parity full width (resnet50_rnn from a reference .pth, random "
            f"weights, bf16, --device_postproc cuboid, --batch_size 8, "
            f"--need_preprocess on {PARITY_N} raw panos): exit 0; "
            f"{n_aligned} aligned, {n} scored, metrics "
            f"{json.dumps({k: round(v, 4) for k, v in m.items()})} (random "
            f"weights: no bar); K1 launches {rep['k1']}; seconds a pano: "
            f"alignment {per['pre']:.4f}, inference {per['infer']:.4f} "
            f"(model load included), eval {per['eval']:.4f} [{card}]")
        for line in stdout.strip().splitlines()[-6:]:
            log(f"  {line}")
        note(state, full_metrics=m, full_scored=n, full_k1=rep["k1"],
             full_s_a_pano=per)
    _launched(state, "bilstm_fwd", "parity", launches)

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
                                          fused_block, pad)

    def record(name, source, replaces):
        return {"name": name, "route": "cuda",
                "source": f"horizonnet_tpu_torch/csrc/{source}",
                "replaces": f"horizonnet_tpu/ops/{replaces}",
                "launches": None, "max_abs_err": None, "ms": None,
                "plain_ms": None, "bound_ms": None, "bound_by": None,
                "library_ms": None}

    kernels = {
        "bilstm_fwd": record("bilstm_fwd", "bilstm_fwd.cu",
                             "pallas_lstm.py:31"),
        "bilstm_train_fwd": record("bilstm_train_fwd", "bilstm_train.cu",
                                   "pallas_lstm.py:56"),
        "bilstm_bwd": record("bilstm_bwd", "bilstm_train.cu",
                             "pallas_lstm.py:87"),
        "fused_bottleneck": record("fused_bottleneck", "fused_bottleneck.cu",
                                   "pallas_block.py:58"),
        "wrap_pad": record("wrap_pad", "wrap_pad.cu",
                           "pad.py:wrap_pad_width (jnp.concatenate)")}
    state = {"card": card_line(), "launches": {}, "summary": {},
             "kernels": kernels}
    log(state["card"])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(m.build)
                  for m in (cuda_lstm, cuda_lstm_train, fused_block, pad)]:
            f.result()
    log(f"K1, K2/K3, K4 and K5 builds (nvcc in parallel, or the cached "
        f"libraries): {time.perf_counter() - t0:.1f} s")

    phases = {"kernel": phase_kernel, "golden": phase_golden,
              "flagship": phase_flagship, "fused": phase_fused,
              "general": phase_general, "cli": phase_cli,
              "host": phase_host, "train": phase_train,
              "train_cli": phase_train_cli, "dynamics": phase_dynamics,
              "densenet": phase_densenet, "quant": phase_quant,
              "preprocess": phase_preprocess, "eval": phase_eval,
              "parity": phase_parity, "bench": phase_bench,
              "parallel": phase_parallel, "pad": phase_pad}
    for name in args.phases:
        t0 = time.perf_counter()
        state["phase"] = name
        log(f"== phase {name}")
        phases[name](state)
        secs = time.perf_counter() - t0
        note(state, seconds=secs)
        log(f"== phase {name} ok ({secs:.1f} s)")

    # the summary: every phase's headline numbers, compact, after the log
    log("== summary (ms: CUDA-event medians; rates in panos/s; each phase's "
        "log line above has the method)")
    log(state["card"])
    for name, numbers in state["summary"].items():
        log(f"summary {name} "
            f"{json.dumps(_compact(numbers), separators=(',', ':'))}")
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
