"""Host (numpy + C++) twins of the preprocess warps: the default backend.

Copied from horizonnet_tpu/preprocess/host_resample.py. The VP pipeline
around these warps is host work (C++ LSD, numpy merge/Hough/refit), and the
26-view cut is a *fixed* gather (the view grid never changes) while the
alignment rotation is one 3x3 product plus per-pixel trig, so both run in
tens of milliseconds on one CPU core with the tables below precomputed. On
a host whose device link is slow the transfers cost more than the
arithmetic; ``views.preprocess_backend`` picks between the two.

Semantics match the device paths up to f32 rounding:
- view cutting: views._view_source_coords (tangent-plane rays, reference
  imgLookAt, misc/pano_lsd_align.py:174-225) + period-N wrap bilinear
  (ops/resample.py);
- rotation: rotate._rotate_f32 (reference rotatePanorama,
  misc/pano_lsd_align.py:125-171, without its bottom-row typo).

The C++ warp (warp.cpp) equals its numpy twin (``_gather_mix``) bit for
bit; without g++ the numpy twin runs, as in the JAX package.
"""

import ctypes
import os

import numpy as np

# ---------------------------------------------------------------------------
# native warp kernel (warp.cpp) — numpy gather tables as fallback

_DIR = os.path.dirname(os.path.abspath(__file__))
_WARP_SRC = os.path.join(_DIR, "warp.cpp")
_warp_lib = None
_warp_failed = False


def _warp():
    """Build+load warp.cpp once; None if the toolchain is unavailable."""
    global _warp_lib, _warp_failed
    if _warp_lib is None and not _warp_failed:
        try:
            from ._build import build_and_load
            lib = build_and_load(
                _WARP_SRC, extra_flags=("-march=native", "-ffp-contract=off"))
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.warp_bilinear_wrap_f32.restype = None
            lib.warp_bilinear_wrap_f32.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, f32p, ctypes.c_long, f32p]
            lib.warp_bilinear_wrap_u8.restype = None
            lib.warp_bilinear_wrap_u8.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, f32p, ctypes.c_long, u8p]
            _warp_lib = lib
        except (OSError, RuntimeError):    # no g++, or no build: numpy path
            _warp_failed = True
    return _warp_lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _warp_f32(img, H, W, py, px):
    """img: [H, W(, C)] f32 contiguous; py/px: f32 arrays (same shape S).

    Returns S (+ [C]) f32 via the native kernel, or the numpy tables.
    """
    C = 1 if img.ndim == 2 else img.shape[-1]
    lib = _warp()
    if lib is None:
        idx, wts = _bilinear_wrap_tables(py, px, H, W)
        return _gather_mix(img.reshape(H * W, -1) if C > 1
                           else img.reshape(-1), idx, wts)
    img = np.ascontiguousarray(img, np.float32)
    pyf = np.ascontiguousarray(py, np.float32).ravel()
    pxf = np.ascontiguousarray(px, np.float32).ravel()
    out = np.empty((pyf.size, C), np.float32)
    lib.warp_bilinear_wrap_f32(_f32p(img), H, W, C, _f32p(pyf),
                               _f32p(pxf), pyf.size, _f32p(out))
    shape = py.shape + ((C,) if img.ndim == 3 else ())
    return out.reshape(shape)


def _warp_u8(img, H, W, py, px):
    """uint8 variant with device-matching floor quantization."""
    C = img.shape[-1] if img.ndim == 3 else 1
    lib = _warp()
    if lib is None:
        idx, wts = _bilinear_wrap_tables(py, px, H, W)
        out = _gather_mix(img.reshape(H * W, -1).astype(np.float32),
                          idx, wts)
        out = np.clip(np.floor(out), 0, 255).astype(np.uint8)
        return out.reshape(py.shape + ((C,) if img.ndim == 3 else ()))
    img = np.ascontiguousarray(img, np.uint8)
    pyf = np.ascontiguousarray(py, np.float32).ravel()
    pxf = np.ascontiguousarray(px, np.float32).ravel()
    out = np.empty((pyf.size, C), np.uint8)
    lib.warp_bilinear_wrap_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, C,
        _f32p(pyf), _f32p(pxf), pyf.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape(py.shape + ((C,) if img.ndim == 3 else ()))


# ---------------------------------------------------------------------------
# wrap-bilinear gather tables


def _bilinear_wrap_tables(py, px, H, W):
    """Flat gather indices + lerp weights for period-N wrap sampling.

    py/px: float arrays (any shape). Returns 4 int32 index arrays into
    the H*W-flattened image and 4 float32 weight arrays, all of py's
    shape. Matches ops/resample.bilinear_wrap_sample exactly.
    """
    y0 = np.floor(py)
    x0 = np.floor(px)
    wy = (py - y0).astype(np.float32)
    wx = (px - x0).astype(np.float32)
    y0i = np.mod(y0.astype(np.int64), H).astype(np.int32)
    y1i = ((y0i + 1) % H).astype(np.int32)
    x0i = np.mod(x0.astype(np.int64), W).astype(np.int32)
    x1i = ((x0i + 1) % W).astype(np.int32)
    i00 = y0i * W + x0i
    i01 = y0i * W + x1i
    i10 = y1i * W + x0i
    i11 = y1i * W + x1i
    w11 = wy * wx
    w10 = wy - w11
    w01 = wx - w11
    w00 = 1.0 - wy - w01
    return (i00, i01, i10, i11), (w00, w01, w10, w11)


def _gather_mix(flat, idx, wts):
    """flat: [H*W] or [H*W, C] float32. Returns idx[0].shape (+ [C])."""
    (i00, i01, i10, i11), (w00, w01, w10, w11) = idx, wts
    if flat.ndim == 2:
        w00, w01, w10, w11 = (w[..., None] for w in (w00, w01, w10, w11))
    return (flat[i00] * w00 + flat[i01] * w01
            + flat[i10] * w10 + flat[i11] * w11)


# ---------------------------------------------------------------------------
# 26-view cut (fixed geometry -> fully precomputed tables)


def _view_source_coords_np(vx, vy, size, fov, H, W):
    """numpy twin of views._view_source_coords, vectorized over views.

    vx/vy: [V] view pan/tilt. Returns (py, px) [V, size, size] float32,
    0-based sample coordinates into the [H, W] pano.
    """
    vx = np.asarray(vx, np.float32)[:, None, None]
    vy = np.asarray(vy, np.float32)[:, None, None]
    t = np.arange(1, size + 1, dtype=np.float32) - 0.5 - size / 2
    TX = t[None, None, :]
    TY = t[None, :, None]
    r = np.float32(size / 2 / np.tan(fov / 2))

    R = np.sqrt(TY ** 2 + r ** 2)
    ang_y = np.arctan(-TY / r) + vy
    X = np.sin(ang_y) * R
    Y = -np.cos(ang_y) * R
    Z = TX  # [1, 1, S]; broadcasts against X/Y's [V, S, 1] below

    flip = np.abs(ang_y) > np.pi / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        ang_x = np.arctan(Z / -Y)
    ang_x = np.where(flip, ang_x + np.float32(np.pi), ang_x)

    RZY = np.sqrt(Z ** 2 + Y ** 2)
    ang_y2 = np.arctan(X / RZY)
    ang_x = ang_x + vx

    below = ang_y2 < -np.pi / 2
    ang_y2 = np.where(below, np.float32(-np.pi) - ang_y2, ang_y2)
    ang_x = np.where(below, ang_x + np.float32(np.pi), ang_x)
    ang_x = np.mod(ang_x + np.float32(np.pi),
                   np.float32(2 * np.pi)) - np.float32(np.pi)

    Px = (ang_x + np.float32(np.pi)) / np.float32(2 * np.pi) * W + 0.5
    Py = (-ang_y2 + np.float32(np.pi / 2)) / np.float32(np.pi) * H + 0.5
    return (Py - 1.0).astype(np.float32), (Px - 1.0).astype(np.float32)


_VIEW_COORDS = {}


def _view_coords(H, W, size, fov, directions):
    """Cached per-(geometry) source coords [V, S, S] f32 ×2."""
    xs, ys = directions
    key = (H, W, size, round(float(fov), 9),
           tuple(np.round(np.asarray(xs, np.float64), 9)),
           tuple(np.round(np.asarray(ys, np.float64), 9)))
    tab = _VIEW_COORDS.get(key)
    if tab is None:
        py, px = _view_source_coords_np(xs, ys, size, float(fov), H, W)
        tab = (np.ascontiguousarray(py), np.ascontiguousarray(px))
        _VIEW_COORDS[key] = tab
    return tab


_GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)  # ITU-R 601 luma


def cut_views_gray_host(pano, size=320, fov=np.pi / 3, directions=None):
    """Cut all views + luma on host: [H, W, 3] 0..255 -> [V, S, S] f32.

    Same values as views.cut_views_gray before its f16 download cast
    (the host path has no link to save bytes on, so it keeps f32).
    """
    from .views import VIEW_DIRECTIONS
    if directions is None:
        directions = VIEW_DIRECTIONS
    pano = np.asarray(pano)
    H, W = pano.shape[:2]
    py, px = _view_coords(H, W, size, float(fov), directions)
    gray = pano.astype(np.float32) @ _GRAY        # [H, W]
    return _warp_f32(gray, H, W, py, px)


def cut_views_host(pano, size=320, fov=np.pi / 3, directions=None):
    """RGB variant (debug artifacts): [H, W, C] -> [V, S, S, C] f32."""
    from .views import VIEW_DIRECTIONS
    if directions is None:
        directions = VIEW_DIRECTIONS
    pano = np.asarray(pano)
    H, W = pano.shape[:2]
    py, px = _view_coords(H, W, size, float(fov), directions)
    return _warp_f32(pano.astype(np.float32), H, W, py, px)


# ---------------------------------------------------------------------------
# VP-alignment rotation (fixed direction grid; per-pano 3x3 + trig)

_DIR_GRIDS = {}


def _direction_grid(H, W):
    """planeID=1 sphere direction per output pixel: [H*W, 3] float32."""
    grid = _DIR_GRIDS.get((H, W))
    if grid is None:
        xs = ((np.arange(1, W + 1, dtype=np.float32) - W / 2 - 0.5)
              / W * 2 * np.pi)
        ys = -((np.arange(1, H + 1, dtype=np.float32) - H / 2 - 0.5)
               / H * np.pi)
        u = np.broadcast_to(xs[None, :], (H, W))
        v = np.broadcast_to(ys[:, None], (H, W))
        cv = np.cos(v)
        grid = np.stack([cv * np.sin(u), cv * np.cos(u),
                         np.broadcast_to(np.sin(v), (H, W))],
                        -1).reshape(-1, 3).astype(np.float32)
        _DIR_GRIDS[(H, W)] = grid
    return grid


def _rotate_source_coords(Rinv, H, W):
    """Source (py, px) per output pixel — twin of rotate._rotate_f32."""
    xyz = _direction_grid(H, W)
    old = xyz @ Rinv.astype(np.float32).T          # [H*W, 3]
    ox, oy, oz = old[:, 0], old[:, 1], old[:, 2]
    norm_xy = np.maximum(np.sqrt(ox ** 2 + oy ** 2), np.float32(1e-6))
    norm = np.sqrt(ox ** 2 + oy ** 2 + oz ** 2)
    ov = np.arcsin(np.clip(oz / norm, -1, 1))
    ou = np.arcsin(np.clip(ox / norm_xy, -1, 1))
    neg = oy < 0
    ou = np.where(neg & (ou >= 0), np.float32(np.pi) - ou, ou)
    ou = np.where(neg & (ou < 0), np.float32(-np.pi) - ou, ou)
    Px = (ou + np.float32(np.pi)) / np.float32(2 * np.pi) * W + 0.5
    Py = (-ov + np.float32(np.pi / 2)) / np.float32(np.pi) * H + 0.5
    return Py - 1.0, Px - 1.0


def _rinv(vp, R):
    if R is None:
        R = np.linalg.inv(np.asarray(vp, np.float64).T)
    return np.linalg.inv(R)


def rotate_panorama_host(img, vp=None, R=None):
    """Float path: [H, W(, C)] -> same shape, float32."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    py, px = _rotate_source_coords(_rinv(vp, R), H, W)
    return _warp_f32(img, H, W, py.reshape(H, W),
                     px.reshape(H, W)).reshape(img.shape)


def rotate_panorama_uint8_host(img_u8, vp=None, R=None):
    """uint8 path: floor-quantized like rotate.rotate_panorama_uint8."""
    img_u8 = np.asarray(img_u8)
    H, W = img_u8.shape[:2]
    py, px = _rotate_source_coords(_rinv(vp, R), H, W)
    return _warp_u8(img_u8, H, W, py.reshape(H, W),
                    px.reshape(H, W)).reshape(img_u8.shape)
