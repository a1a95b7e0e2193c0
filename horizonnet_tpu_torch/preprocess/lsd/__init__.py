"""ctypes binding for the in-house C++ LSD line-segment detector.

Copied from horizonnet_tpu/preprocess/lsd/__init__.py. Builds lsd.cpp with
g++ on first use into build/preprocess/ (``.._build``). The
detector replaces pylsd (reference misc/pano_lsd_align.py:16): same
algorithm (von Gioi et al., IPOL 2012), same parameter surface, output
rows [x1, y1, x2, y2, width, log_nfa].
"""

import ctypes
import os

import numpy as np

from .._build import build_and_load

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "lsd.cpp")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # build_and_load serializes check+compile+dlopen and publishes the
    # .so atomically (the preprocess CLI races many threads into here)
    lib = build_and_load(_SRC, extra_flags=("-march=native", "-pthread"))
    lib.lsd_detect.restype = ctypes.c_int
    lib.lsd_detect.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
    ]
    lib.lsd_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.lsd_detect_batch.restype = None
    lib.lsd_detect_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return lib


def lsd(img, scale=0.8, sigma_scale=0.6, quant=2.0, ang_th=22.5,
        log_eps=0.0, density_th=0.7, n_bins=1024):
    """Detect line segments in a grayscale image.

    img: [H, W] float or uint8 (0..255 range). Returns (N, 6) float64
    rows [x1, y1, x2, y2, width, log_nfa] in image pixel coordinates.
    Defaults mirror the published algorithm; the reference pipeline calls
    with quant=0.7 (pano_lsd_align.py:260).
    """
    lib = _load()
    img = np.ascontiguousarray(np.asarray(img, np.float64))
    assert img.ndim == 2, "grayscale input expected"
    h, w = img.shape
    out = ctypes.POINTER(ctypes.c_double)()
    n = lib.lsd_detect(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), w, h,
        scale, sigma_scale, quant, ang_th, log_eps, density_th, n_bins,
        ctypes.byref(out))
    if n == 0:
        lib.lsd_free(out)
        return np.zeros((0, 6))
    res = np.ctypeslib.as_array(out, shape=(n, 6)).copy()
    lib.lsd_free(out)
    return res


def lsd_batch(imgs, num_workers=None, scale=0.8, sigma_scale=0.6,
              quant=2.0, ang_th=22.5, log_eps=0.0, density_th=0.7,
              n_bins=1024):
    """Detect segments in many images with the native thread pool.

    Same-shaped batches (the pipeline's 26 views) go through ONE ctypes
    call into lsd_detect_batch, which fans out across std::thread
    workers — no Python thread per view. Mixed shapes fall back to a
    host loop. ``num_workers`` caps the native pool (None = hardware
    concurrency); pass 1 when an outer pano-level pool already owns the
    cores. Returns a list of (N_i, 6) arrays in input order.
    """
    imgs = list(imgs)
    if len(imgs) == 0:
        return []
    lib = _load()
    shapes = {np.asarray(im).shape for im in imgs}
    if len(imgs) == 1 or len(shapes) > 1:
        return [lsd(im, scale=scale, sigma_scale=sigma_scale, quant=quant,
                    ang_th=ang_th, log_eps=log_eps, density_th=density_th,
                    n_bins=n_bins) for im in imgs]

    batch = np.ascontiguousarray(np.stack(
        [np.asarray(im, np.float64) for im in imgs]))
    n, h, w = batch.shape
    outs = (ctypes.POINTER(ctypes.c_double) * n)()
    counts = (ctypes.c_int * n)()
    lib.lsd_detect_batch(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, w, h,
        scale, sigma_scale, quant, ang_th, log_eps, density_th, n_bins,
        int(num_workers or 0), outs, counts)
    results = []
    for i in range(n):
        c = int(counts[i])
        if c == 0:
            results.append(np.zeros((0, 6)))
        else:
            results.append(
                np.ctypeslib.as_array(outs[i], shape=(c, 6)).copy())
        lib.lsd_free(outs[i])
    return results
