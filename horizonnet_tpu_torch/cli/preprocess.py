"""Preprocess CLI: VP detection + alignment warps + line maps.

Counterpart of horizonnet_tpu/cli/preprocess.py (reference surface:
preprocess.py), flag for flag, plus ``--device``:

    python -m horizonnet_tpu_torch.cli.preprocess --img_glob 'raw/*.png' \\
        --output_dir out [--rgbonly] [--num_workers N] [--profile] \\
        [--device cuda]

Writes per input pano:
- ``{name}_VP.txt``       3x3 vanishing-point rows (same order/format)
- ``{name}_aligned_rgb.png``  VP-aligned pano
- ``{name}_aligned_line.png`` VP-aligned 3-channel line-segment raster
or just ``{name}.png`` with --rgbonly.

``--device`` (default cuda; a missing CUDA device is an error) picks where
the two warps run: on a CUDA device the 26 view cuts and the alignment
rotation run as torch programs on the card (the ``device`` backend); with
``--device cpu`` they run on the host (numpy + C++ gather tables, the JAX
CLI's default). HORIZONNET_PREPROCESS_BACKEND=host|device overrides the
choice. LSD, merge, Hough and refit are host work on either backend.

Panos are independent, so the stage parallelizes across a thread pool
(--num_workers): the C++ LSD detector and the device work both release
the interpreter lock, and per-pano host numpy + PNG encode overlap across
threads. The reference processes its datasets strictly serially
(preprocess.py:52).
"""

import argparse
import glob
import os
import sys
import time

import numpy as np


def _process_one(i_path, args, backend, device, lsd_workers=None):
    from ..preprocess import pano_edge_detection, rotate_panorama_uint8
    from ..utils.image import load_pano, write_png
    from ..utils import profiling

    with profiling.span("preprocess/decode"):
        img_ori = load_pano(i_path)

    result = pano_edge_detection(img_ori, q_error=args.q_error,
                                 refine_iter=args.refine_iter,
                                 want_pano_edge=not args.rgbonly,
                                 lsd_workers=lsd_workers, backend=backend,
                                 device=device)
    vp = result["vp"]
    if vp is None:
        return f"[WARN] VP detection failed for {i_path}"

    basename = os.path.splitext(os.path.basename(i_path))[0]
    warp = dict(backend=backend, device=device)
    if args.rgbonly:
        with profiling.span("preprocess/rotate"):
            i_img = rotate_panorama_uint8(img_ori, vp[2::-1], **warp)
        with profiling.span("preprocess/encode_png"):
            write_png(os.path.join(args.output_dir, f"{basename}.png"),
                      i_img, level=1)
    else:
        # RGB + line raster warped in ONE program ([H, W, 6]), uint8 both
        # ways across the link (the PNGs are uint8 anyway)
        with profiling.span("preprocess/rotate"):
            pano_edge = (result["pano_edge"] > 0)
            both = np.concatenate(
                [img_ori, pano_edge.astype(np.uint8) * 255], axis=-1)
            both = rotate_panorama_uint8(both, vp[2::-1], **warp)
            i_img, l_img = both[..., :3], both[..., 3:]
        with open(os.path.join(args.output_dir,
                               f"{basename}_VP.txt"), "w") as f:
            for i in range(3):
                f.write("%.6f %.6f %.6f\n" % tuple(vp[i]))
        with profiling.span("preprocess/encode_png"):
            # zlib level 1: these PNGs are pipeline intermediates, not
            # archives (the JAX CLI measured 56 against 213 ms a pano for
            # ~17% more bytes)
            write_png(os.path.join(args.output_dir,
                                   f"{basename}_aligned_rgb.png"),
                      i_img, level=1)
            write_png(os.path.join(args.output_dir,
                                   f"{basename}_aligned_line.png"),
                      l_img, level=1)
    return None


def warp_backend(device):
    """The preprocess backend for ``device``: the device warps on a CUDA
    device, the host warps otherwise; HORIZONNET_PREPROCESS_BACKEND
    overrides."""
    from ..preprocess.views import preprocess_backend

    return preprocess_backend(
        os.environ.get("HORIZONNET_PREPROCESS_BACKEND")
        or ("device" if device.type == "cuda" else "host"))


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--img_glob", required=True,
                        help="quoted glob of input panos")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--rgbonly", action="store_true",
                        help="only write the aligned RGB (custom datasets)")
    parser.add_argument("--q_error", default=0.7, type=float)
    parser.add_argument("--refine_iter", default=3, type=int)
    parser.add_argument("--num_workers", default=0, type=int,
                        help="thread pool size for pano-level parallelism "
                             "(0 = min(8, cpu_count))")
    parser.add_argument("--profile", action="store_true",
                        help="record spans and print per-stage wall-clock "
                             "totals to stderr at exit (utils/profiling.py)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the warps (cuda: the device "
                             "backend; cpu: the host backend); a missing "
                             "CUDA device is an error")
    args = parser.parse_args(argv)

    from ..inference import resolve_device

    device = resolve_device(args.device)
    backend = warp_backend(device)

    paths = sorted(glob.glob(args.img_glob))
    if len(paths) == 0:
        print("no images found", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    from ..utils import profiling

    if not args.profile:
        return _run(paths, args, backend, device)
    t0 = time.perf_counter_ns()
    with profiling.enable():
        rc = _run(paths, args, backend, device)
    print(profiling.report(t0), file=sys.stderr)
    return rc


def _run(paths, args, backend, device):
    workers = args.num_workers or min(8, os.cpu_count() or 1)
    workers = min(workers, len(paths))

    try:  # progress: this is the reference's slowest stage (README TODO)
        from tqdm import tqdm
    except ImportError:
        tqdm = None

    if workers <= 1:
        it = tqdm(paths, unit="pano") if tqdm else paths
        for i_path in it:
            warn = _process_one(i_path, args, backend, device)
            if warn:
                print(warn, file=sys.stderr)
        return 0

    # Split the cores between the pano pool and each pano's inner LSD
    # fan-out: ``workers`` panos in flight each get cpu/workers LSD
    # threads instead of a full cpu_count pool per pano
    inner = max(1, (os.cpu_count() or 1) // workers)
    from concurrent.futures import ThreadPoolExecutor, as_completed
    with ThreadPoolExecutor(workers) as pool:
        futs = {pool.submit(_process_one, p, args, backend, device, inner): p
                for p in paths}
        done = as_completed(futs)
        if tqdm:
            done = tqdm(done, total=len(futs), unit="pano")
        for fut in done:
            warn = fut.result()
            if warn:
                print(warn, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
