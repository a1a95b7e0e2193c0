"""Standalone VP-detection debug harness (one image, timing + overlays).

Counterpart of horizonnet_tpu/cli/vp_debug.py (reference surface: the
__main__ harness of misc/pano_lsd_align.py:871-914), flag for flag, plus
``--device`` as in ``cli/preprocess.py`` (default cuda: the device warps;
cpu: the host warps; HORIZONNET_PREPROCESS_BACKEND overrides). Runs VP
detection on a single pano, prints elapsed time and the vanishing points,
and dumps three diagnostics: the VP-aligned edge map (_edg.png), the
VP-aligned pano (_img.png), and a composite overlay with line classes
painted over a dimmed pano (_one.png).
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--i", required=True, help="input pano image")
    parser.add_argument("--o_prefix", required=True,
                        help="output path prefix for _edg/_img/_one.png")
    parser.add_argument("--qError", default=0.7, type=float)
    parser.add_argument("--refineIter", default=3, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the warps; a missing CUDA "
                             "device is an error")
    args = parser.parse_args(argv)

    from ..inference import resolve_device
    from ..preprocess import pano_edge_detection, rotate_panorama
    from ..utils.image import load_pano, write_png
    from .preprocess import warp_backend

    device = resolve_device(args.device)
    warp = dict(backend=warp_backend(device), device=device)
    img_ori = load_pano(args.i)

    s_time = time.time()
    result = pano_edge_detection(img_ori, q_error=args.qError,
                                 refine_iter=args.refineIter, **warp)
    print("Elapsed time: %.2f" % (time.time() - s_time))
    vp = result["vp"]
    if vp is None:
        print("VP estimation failed (degenerate line set)", file=sys.stderr)
        return 1
    pano_edge = result["pano_edge"] > 0

    print("Vanishing point:")
    for v in vp[2::-1]:
        print("%.6f %.6f %.6f" % tuple(v))

    edg = rotate_panorama(pano_edge.astype(np.float32), vp[2::-1], **warp)
    img = rotate_panorama(img_ori.astype(np.float32) / 255.0, vp[2::-1],
                          **warp)
    one = img.copy() * 0.5
    one[(edg > 0.5).sum(-1) > 0] = 0
    for c in range(3):
        one[edg[..., c] > 0.5, c] = 1
    for name, out in (("edg", edg), ("img", img), ("one", one)):
        write_png(f"{args.o_prefix}_{name}.png", (out * 255).astype(np.uint8))
    return 0


if __name__ == "__main__":
    sys.exit(main())
