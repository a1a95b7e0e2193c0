#!/usr/bin/env python3
"""One command from weights + dataset to the reference README tables.

Counterpart of tools/parity_eval.py, flag for flag, plus ``--device``
(default cuda; a missing CUDA device is an error, as in the port's other
CLIs), passed on to the preprocess and inference CLIs:

    python3 horizonnet_tpu_torch/tools/parity_eval.py \\
        --pth resnet50_rnn__panos2d3d.pth \\
        --root_dir data/layoutnet_dataset/test --dataset panocontext

runs convert (a reference .pth or a .ckpt loads through
train/checkpoint.py::load_trained_model) -> optional VP alignment
(--need_preprocess, for raw datasets: cli/preprocess.py --rgbonly) ->
batched inference (cli/inference.py; the bi-LSTM recurrence on a CUDA
device is the CUDA kernel, csrc/bilstm_fwd.cu) -> the matching eval
(cuboid CE/PE/3DIoU or general 2D/3D IoU + depth, evals/) and prints a
side-by-side against the published numbers with tolerances.

Dataset presets carry the reference's exact recipes and numbers:
- cuboid table:   README.md:173-196 (inference --force_cuboid, then
  eval_cuboid; PanoContext = label_cor/pano*txt,
  Stanford2D3D = label_cor/camera*txt)
- ST3D:           README_ST3D.md:36-56 (general mode)
- ZInD:           README_ZInD.md:33-58 (general; the "w/o post" row is
  --force_raw)

Exit status: 0 = all metrics within tolerance (or no expectations),
1 = no pano matches the glob, 2 = parity failed. The harness runs end to
end in tests/test_torch_parity_eval.py on the committed golden checkpoint
and fixture room, against the JAX package's harness on the same inputs.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

# Published numbers (in %), with the reference recipe per row.
PRESETS = {
    "panocontext": {          # README.md:194
        "mode": "cuboid", "gt_pattern": "pano*txt",
        "expect": {"3DIoU": 83.39, "CE": 0.76, "PE": 2.13}},
    "stanford2d3d": {         # README.md:195
        "mode": "cuboid", "gt_pattern": "camera*txt",
        "expect": {"3DIoU": 84.09, "CE": 0.63, "PE": 2.06}},
    "panos2d3d": {            # README.md:196 ("All")
        "mode": "cuboid", "gt_pattern": "*txt",
        "expect": {"3DIoU": 83.87, "CE": 0.67, "PE": 2.08}},
    "st3d": {                 # README_ST3D.md:47-56 (overall row)
        "mode": "general", "gt_pattern": "*",
        "expect": {"3DIoU": 91.31, "2DIoU": 92.63}},
    "zind": {                 # README_ZInD.md:48-58 (w/ post-proc)
        "mode": "general", "gt_pattern": "*",
        "expect": {"3DIoU": 67.52, "2DIoU": 68.48}},
    "zind_raw": {             # README_ZInD.md:48-58 (w/o post-proc)
        "mode": "general", "gt_pattern": "*", "force_raw": True,
        "expect": {"3DIoU": 88.47, "2DIoU": 89.80}},
    "custom": {"mode": "cuboid", "gt_pattern": "*txt", "expect": {}},
}

# Default tolerances (percentage points). IoU-class metrics drift with
# fp/TTA details; CE/PE are tighter. Override per run with --tol.
DEFAULT_TOL = {"3DIoU": 1.0, "2DIoU": 1.0, "CE": 0.15, "PE": 0.35,
               "rmse": 0.05, "delta_1": 0.02}


def run_inference(args, img_glob, out_dir):
    from horizonnet_tpu_torch.cli.inference import main as inference_main

    argv = ["--pth", args.pth, "--img_glob", img_glob,
            "--output_dir", out_dir, "--batch_size", str(args.batch_size),
            "--device", args.device]
    if args.mode == "cuboid":
        argv.append("--force_cuboid")
    if args.force_raw:
        argv.append("--force_raw")
    if args.device_postproc:
        argv.append("--device_postproc")
    if args.bf16:
        argv.append("--bf16")
    rc = inference_main(argv)
    if rc != 0:
        raise SystemExit(f"inference failed (rc={rc})")


def eval_cuboid_metrics(gt_glob, dt_glob, w, h):
    from horizonnet_tpu_torch.evals import prepare_gtdt_pairs, test_cuboid

    pairs = prepare_gtdt_pairs(gt_glob, dt_glob)
    losses = {"CE": [], "PE": [], "3DIoU": []}
    for gt_path, dt_path in pairs:
        with open(gt_path) as f:
            gt_cor_id = np.array([ln.split() for ln in f], np.float32)
        with open(dt_path) as f:
            dt = json.load(f)
        dt_cor_id = np.array(dt["uv"], np.float32) * [w, h]
        test_cuboid(dt_cor_id, dt["z0"], dt["z1"], gt_cor_id, w, h, losses)
    return {k: float(np.mean(v)) for k, v in losses.items()}, len(pairs)


def eval_general_metrics(gt_glob, dt_glob, w, h):
    from horizonnet_tpu_torch.evals import (new_general_losses,
                                            prepare_gtdt_pairs,
                                            summarize_general, test_general)

    pairs = prepare_gtdt_pairs(gt_glob, dt_glob)
    losses = new_general_losses()
    for gt_path, dt_path in pairs:
        with open(gt_path) as f:
            gt_cor_id = np.array([ln.split() for ln in f], np.float32)
        with open(dt_path) as f:
            dt = json.load(f)
        dt_cor_id = np.array(dt["uv"], np.float32) * [w, h]
        test_general(dt_cor_id, gt_cor_id, w, h, losses, gt_path=gt_path)
    summary = summarize_general(losses, stream=sys.stderr)
    overall = summary.get("overall", {})
    out = {"2DIoU": overall.get("2DIoU", 0.0) * 100,
           "3DIoU": overall.get("3DIoU", 0.0) * 100,
           "rmse": overall.get("rmse", 0.0),
           "delta_1": overall.get("delta_1", 0.0)}
    return out, len(pairs)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--pth", required=True,
                        help="checkpoint: reference .pth or our .ckpt")
    parser.add_argument("--root_dir",
                        help="dataset dir holding img/ and label_cor/")
    parser.add_argument("--img_glob", help="override pano glob")
    parser.add_argument("--gt_glob", help="override GT corner-txt glob")
    parser.add_argument("--dataset", default="custom",
                        choices=sorted(PRESETS))
    parser.add_argument("--mode", choices=["cuboid", "general"],
                        help="override the preset's eval mode")
    parser.add_argument("--force_raw", action="store_true", default=None,
                        help="raw 1024-column polygon (ZInD w/o post row)")
    parser.add_argument("--need_preprocess", action="store_true",
                        help="VP-align the panos first (raw datasets)")
    parser.add_argument("--output_dir",
                        help="keep intermediate jsons here (default: tmp)")
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--device_postproc", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--w", default=1024, type=int)
    parser.add_argument("--h", default=512, type=int)
    parser.add_argument("--expect", nargs="*", default=None,
                        metavar="METRIC=VALUE",
                        help="override expected numbers, e.g. 3DIoU=83.39")
    parser.add_argument("--tol", nargs="*", default=[],
                        metavar="METRIC=TOL",
                        help="override tolerances, e.g. 3DIoU=0.5")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the alignment warps and the "
                             "inference; a missing CUDA device is an error")
    args = parser.parse_args(argv)
    if args.root_dir is None and not (args.img_glob and args.gt_glob):
        parser.error("--root_dir is required unless BOTH --img_glob and "
                     "--gt_glob are given")

    from horizonnet_tpu_torch.inference import resolve_device

    resolve_device(args.device)
    preset = PRESETS[args.dataset]
    args.mode = args.mode or preset["mode"]
    if args.force_raw is None:
        args.force_raw = preset.get("force_raw", False)
    expect = dict(preset["expect"])
    if args.expect is not None:
        expect = {k: float(v) for k, v in
                  (e.split("=") for e in args.expect)}
    tol = dict(DEFAULT_TOL)
    tol.update({k: float(v) for k, v in (e.split("=") for e in args.tol)})

    img_glob = args.img_glob or os.path.join(args.root_dir, "img", "*")
    gt_glob = args.gt_glob or os.path.join(args.root_dir, "label_cor",
                                           preset["gt_pattern"])
    if not glob.glob(img_glob):
        print(f"no panos match {img_glob}", file=sys.stderr)
        return 1

    work = args.output_dir or tempfile.mkdtemp(prefix="parity_eval_")
    os.makedirs(work, exist_ok=True)
    try:
        if args.need_preprocess:
            from horizonnet_tpu_torch.cli.preprocess import main as pre_main
            aligned = os.path.join(work, "aligned")
            rc = pre_main(["--img_glob", img_glob, "--output_dir", aligned,
                           "--rgbonly", "--device", args.device])
            if rc != 0:
                raise SystemExit(f"preprocess failed (rc={rc})")
            img_glob = os.path.join(aligned, "*.png")

        dt_dir = os.path.join(work, "dt")
        run_inference(args, img_glob, dt_dir)
        dt_glob = os.path.join(dt_dir, "*.json")

        if args.mode == "cuboid":
            metrics, n = eval_cuboid_metrics(gt_glob, dt_glob,
                                             args.w, args.h)
        else:
            metrics, n = eval_general_metrics(gt_glob, dt_glob,
                                              args.w, args.h)
    finally:
        if args.output_dir is None:
            shutil.rmtree(work, ignore_errors=True)

    failed = report(args.dataset, args.mode, n, metrics, expect, tol)
    if failed:
        print(f"PARITY FAILED on: {', '.join(failed)}", file=sys.stderr)
        return 2
    if expect:
        print("PARITY OK")
    return 0


def report(dataset, mode, n, metrics, expect, tol, stream=None):
    """Print the side-by-side table; return the list of failed metrics."""
    stream = stream or sys.stdout
    print(f" parity: {dataset} ({n} instances, mode={mode}) "
          .center(64, "="), file=stream)
    print(f"{'metric':<10}{'ours':>10}{'published':>12}{'tol':>8}"
          f"{'verdict':>10}", file=stream)
    failed = []
    for k, v in metrics.items():
        if k in expect:
            ok = abs(v - expect[k]) <= tol.get(k, 1.0)
            if not ok:
                failed.append(k)
            print(f"{k:<10}{v:>10.2f}{expect[k]:>12.2f}"
                  f"{tol.get(k, 1.0):>8.2f}{'PASS' if ok else 'FAIL':>10}",
                  file=stream)
        else:
            print(f"{k:<10}{v:>10.2f}{'-':>12}{'-':>8}{'-':>10}",
                  file=stream)
    print("=" * 64, file=stream)
    return failed


if __name__ == "__main__":
    sys.exit(main())
