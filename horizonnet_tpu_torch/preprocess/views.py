"""Batched perspective view cutting: 26 views in one device gather.

Counterpart of horizonnet_tpu/preprocess/views.py. The reference cuts
views one at a time on the host (separatePano/imgLookAt,
misc/pano_lsd_align.py:174-245), each a full map_coordinates resample.
The device backend computes the source coordinates of every view at once
and samples the pano once: a single [V, S, S] wrap-bilinear gather.

View set (panoEdgeDetection, pano_lsd_align.py:818-827): 12 horizon views
every 30 deg, 12 at elevation +-45 deg, 2 poles; fov pi/3, 320 px.
"""

import os

import numpy as np
import torch

from ..ops.resample import bilinear_wrap_sample_one


def preprocess_backend(backend=None):
    """Resolve the warp backend: 'host' (numpy + C++, default) or 'device'
    (torch on ``device``).

    Every stage around these warps (LSD, merge, Hough, refit) is host
    work, so the device backend pays off only where the host<->device link
    is fast and the host is the bottleneck. HORIZONNET_PREPROCESS_BACKEND
    sets the default.
    """
    b = backend or os.environ.get("HORIZONNET_PREPROCESS_BACKEND", "host")
    if b not in ("host", "device"):
        raise ValueError(f"unknown preprocess backend {b!r}")
    return b


def view_directions():
    xh = np.arange(-np.pi, np.pi * 5 / 6, np.pi / 6)
    yh = np.zeros(len(xh))
    xp = np.array([-3, -2, -1, 0, 1, 2, -3, -2, -1, 0, 1, 2]) / 3 * np.pi
    yp = np.array([1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1]) / 4 * np.pi
    x = np.concatenate([xh, xp, [0, 0]])
    y = np.concatenate([yh, yp, [np.pi / 2, -np.pi / 2]])
    return x, y


VIEW_DIRECTIONS = view_directions()


def _view_source_coords(vx, vy, size, fov, sphereH, sphereW):
    """Pano source pixel coords (y, x) [V, S, S] f32 for views at pan
    ``vx`` and tilt ``vy`` ([V] f32 tensors).

    Tangent-plane ray construction matching imgLookAt
    (pano_lsd_align.py:174-225): pixel offsets (TX, TY) from the view
    center, focal r = S/2/tan(fov/2); tilt by vy around the horizontal
    axis, then pan by vx. It keeps the reference's atan(Z/-Y) with pi added
    where |ang_y| > pi/2, not atan2, as JAX does.
    """
    vx = vx[:, None, None]
    vy = vy[:, None, None]
    t = (torch.arange(1, size + 1, dtype=torch.float32, device=vx.device)
         - 0.5 - size / 2)
    TX = t[None, None, :].expand(1, size, size)   # column offset
    TY = t[None, :, None].expand(1, size, size)   # row offset
    r = size / 2 / np.tan(fov / 2)

    R = torch.sqrt(TY ** 2 + r ** 2)
    ang_y = torch.arctan(-TY / r) + vy

    X = torch.sin(ang_y) * R
    Y = -torch.cos(ang_y) * R
    Z = TX

    flip = torch.abs(ang_y) > np.pi / 2
    ang_x = torch.arctan(Z / -Y)
    ang_x = torch.where(flip, ang_x + np.pi, ang_x)

    RZY = torch.sqrt(Z ** 2 + Y ** 2)
    ang_y2 = torch.arctan(X / RZY)
    ang_x = ang_x + vx

    below = ang_y2 < -np.pi / 2
    ang_y2 = torch.where(below, -np.pi - ang_y2, ang_y2)
    ang_x = torch.where(below, ang_x + np.pi, ang_x)

    # remainder takes the divisor's sign, as jnp.mod does
    ang_x = torch.remainder(ang_x + np.pi, 2 * np.pi) - np.pi

    Px = (ang_x + np.pi) / (2 * np.pi) * sphereW + 0.5
    Py = (-ang_y2 + np.pi / 2) / np.pi * sphereH + 0.5
    # to 0-based sample coordinates
    return Py - 1.0, Px - 1.0


def _device(device):
    return torch.device("cuda" if device is None else device)


def _upload(pano, device):
    """[H, W, C] numpy -> f32 on ``device``; uint8 uploads as uint8, a
    quarter of the bytes."""
    pano = np.asarray(pano)
    if pano.dtype != np.uint8:
        pano = pano.astype(np.float32, copy=False)
    return torch.as_tensor(pano).to(device).float()


def _cut(img, size, fov, directions):
    """Every view of ``img`` [H, W(, C)] f32: [V, S, S(, C)] f32 on its
    device."""
    xs, ys = VIEW_DIRECTIONS if directions is None else directions
    H, W = img.shape[:2]
    xs = torch.as_tensor(np.asarray(xs, np.float32), device=img.device)
    ys = torch.as_tensor(np.asarray(ys, np.float32), device=img.device)
    py, px = _view_source_coords(xs, ys, size, float(fov), H, W)
    return bilinear_wrap_sample_one(img, py, px)


def cut_views(pano, size=320, fov=np.pi / 3, directions=None, backend=None,
              device=None):
    """Cut all views at once. pano: [H, W, C]. Returns [V, S, S, C] f32
    numpy, cut on the host or (device backend) on ``device``, default CUDA.

    Wrap-addressing replaces the reference's 2-column pad + clamp; the two
    agree everywhere except sub-pixel at the seam, where wrap is exact.
    """
    if preprocess_backend(backend) == "host":
        from .host_resample import cut_views_host
        return cut_views_host(pano, size=size, fov=fov,
                              directions=directions)
    return _cut(_upload(pano, _device(device)), size, fov,
                directions).cpu().numpy()


def rgb_to_gray(views):
    """ITU-R 601 luma (cv2 RGB2GRAY weights): [.., 3] -> [..].

    Elementwise product and sum, not a matmul: a matmul may run in reduced
    precision (TF32 on the card), costing ~1/255 of gray precision right at
    LSD's quantization threshold.
    """
    if isinstance(views, np.ndarray):
        w = np.asarray([0.299, 0.587, 0.114], views.dtype)
    else:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=views.dtype,
                         device=views.device)
    return (views * w).sum(-1)


def cut_views_gray(pano, size=320, fov=np.pi / 3, directions=None,
                   backend=None, device=None):
    """Cut all views and reduce to grayscale: [V, S, S] numpy.

    Host backend (default): fixed precomputed gather tables, f32 out.
    Device backend: the luma, the cut and the cast to f16 on ``device``
    (default CUDA), so only [V, S, S] f16 comes back to the host, 6x fewer
    bytes than the RGB views in f32. At the 0..255 luma scale f16 rounds by
    <= ~0.12 gray levels, an order below LSD's quant=0.7 error model.
    A uint8 pano uploads as uint8, 4x fewer bytes than f32. The luma comes
    before the cut, as on the host backend (JAX's device backend cuts the
    RGB first): one channel is gathered instead of three, and the grays
    follow the host's order of operations.
    """
    if preprocess_backend(backend) == "host":
        from .host_resample import cut_views_gray_host
        return cut_views_gray_host(pano, size=size, fov=fov,
                                   directions=directions)
    gray = rgb_to_gray(_upload(pano, _device(device)))
    return _cut(gray, size, fov, directions).to(torch.float16).cpu().numpy()
