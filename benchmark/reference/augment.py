"""Batched augmentation on the device (torch): the reference's copy.

The published augmentations (HorizonNet dataset.py:69-105, pano-stretch,
flip, roll, gamma) composed into one warp field a sample: each output
pixel is one bilinear gather with periodic addressing and one pow.
Composition (output -> source): roll by dx, then flip, then stretch.
``sample_aug_params`` draws one sample's parameters from a numpy
generator, in the published order.
"""

import math

import numpy as np
import torch

from reference.rooms import cor2xybound, stretched_corners

def bilinear_wrap_sample(img, coords_y, coords_x):
    """Sample ``img`` [B, H, W, C] at float coords [B, ...] with periodic
    wrap on both axes. Returns [B, ..., C]."""
    B, H, W, C = img.shape
    y0 = torch.floor(coords_y)
    x0 = torch.floor(coords_x)
    wy = (coords_y - y0)[..., None]
    wx = (coords_x - x0)[..., None]
    y0i = torch.remainder(y0.long(), H)
    y1i = torch.remainder(y0i + 1, H)
    x0i = torch.remainder(x0.long(), W)
    x1i = torch.remainder(x0i + 1, W)

    flat = img.reshape(B, H * W, C)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*coords_y.shape, C)

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x1i) * wx
    bot = tap(y1i, x0i) * (1 - wx) + tap(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def stretch_grid(H, W, kx, ky):
    """Source sampling grid of pano-stretch (ref panostretch.py:91-96) for
    per-sample factors kx, ky [B]. Returns (refy [B, H, W], refx [B, W])
    source pixel coordinates, in float32."""
    dev = kx.device
    us = ((torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W
          - 0.5) * (2 * math.pi)
    vs = ((torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H
          - 0.5) * math.pi
    sin_u, cos_u = torch.sin(us), torch.cos(us)
    tan_v = torch.tan(vs)
    u0 = torch.atan2(sin_u * kx[:, None] / ky[:, None],
                     cos_u.expand(len(kx), W))                       # [B, W]
    ratio = torch.sin(u0) / sin_u * ky[:, None]                      # [B, W]
    v0 = torch.atan(tan_v[None, :, None] * ratio[:, None, :])        # [B,H,W]
    refx = (u0 / (2 * math.pi) + 0.5) * W - 0.5
    refy = (v0 / math.pi + 0.5) * H - 0.5
    return refy, refx


def augment_images(imgs, kx, ky, flip, dx, gamma_p):
    """imgs [B, H, W, 3] float in [0, 1] or uint8 (on the device); per
    sample kx, ky, gamma_p float [B], flip bool [B], dx int [B].
    Returns float32 [B, H, W, 3]."""
    if imgs.dtype == torch.uint8:
        # uint8 crosses the host -> device link 4x cheaper
        imgs = imgs.float() / 255.0
    B, H, W, _ = imgs.shape
    refy, refx = stretch_grid(H, W, kx, ky)
    cols = torch.arange(W, device=imgs.device)
    c1 = torch.remainder(cols[None, :] - dx[:, None], W)            # [B, W]
    c2 = torch.where(flip[:, None], W - 1 - c1, c1)
    src_y = torch.gather(refy, 2, c2[:, None, :].expand(B, H, W))
    src_x = torch.gather(refx, 1, c2)[:, None, :].expand(B, H, W)
    out = bilinear_wrap_sample(imgs, src_y, src_x)
    return torch.pow(out.clamp(0.0, 1.0), gamma_p[:, None, None, None])


def sample_aug_params(rng: np.random.Generator, cor, W,
                      flip=True, rotate=True, gamma=True, stretch=True,
                      max_stretch=2.0):
    """One sample's augmentation parameters from the host RNG. Stretch
    factors are clipped by the room extents as the reference does
    (dataset.py:70-82). Returns a dict of python scalars."""
    kx = ky = 1.0
    if stretch:
        xmin, ymin, xmax, ymax = cor2xybound(cor, W)
        kx = rng.uniform(1.0, max_stretch)
        ky = rng.uniform(1.0, max_stretch)
        if rng.integers(2) == 0:
            kx = max(1 / kx, min(0.5 / xmin, 1.0))
        else:
            kx = min(kx, max(10.0 / xmax, 1.0))
        if rng.integers(2) == 0:
            ky = max(1 / ky, min(0.5 / ymin, 1.0))
        else:
            ky = min(ky, max(10.0 / ymax, 1.0))
    do_flip = bool(flip and rng.integers(2) == 0)
    dx = int(rng.integers(W)) if rotate else 0
    p = 1.0
    if gamma:
        p = rng.uniform(1, 2)
        if rng.integers(2) == 0:
            p = 1 / p
    return {"kx": kx, "ky": ky, "flip": do_flip, "dx": dx, "p": p}


def transform_corners(cor, params, W):
    """The same augmentation applied to the corner list (host, analytic);
    the reference's per-augmentation updates (dataset.py:82,91,98)."""
    cor = np.asarray(cor, np.float64).copy()
    if params["kx"] != 1.0 or params["ky"] != 1.0:
        cor = stretched_corners(cor, params["kx"], params["ky"], W)
    if params["flip"]:
        cor[:, 0] = W - 1 - cor[:, 0]
    if params["dx"]:
        cor[:, 0] = (cor[:, 0] + params["dx"]) % W
    return cor
