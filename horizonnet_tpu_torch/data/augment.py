"""Batched augmentation on the device: stretch + flip + roll + gamma.

Counterpart of horizonnet_tpu/data/augment.py. The reference runs scipy
map_coordinates per channel per sample in DataLoader workers
(dataset.py:69-105, panostretch.py:99-102); here the three geometric
augmentations compose into one warp field per sample, so each output
pixel is one 4-tap gather (ops/resample.py) and one pow, batched over the
device batch.

Composition (output -> source): roll by dx, then flip, then stretch:
  c1 = (j - dx) mod W ; c2 = W-1-c1 if flip ; (y, x) = stretch_grid(c2, i).

Labels (bon, y_cor, corners) are made on the host from the analytically
transformed corners (data/labels.py). ``sample_aug_params`` draws from
the host numpy RNG in the JAX package's order, so one seed gives the same
parameters in both packages.
"""

import math

import numpy as np
import torch

from ..ops import dct as _dct
from ..ops.resample import bilinear_wrap_sample
from .labels import cor2xybound, stretched_corners


def stretch_grid(H, W, kx, ky):
    """Source sampling grid of pano-stretch (ref panostretch.py:91-96) for
    per-sample factors kx, ky [B]. Returns (refy [B, H, W], refx [B, W])
    source pixel coordinates, in float32 as the JAX grid."""
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


def augment_batch(imgs, cors, rng: np.random.Generator, H, W, wire="uint8",
                  *, device, **flags):
    """Whole-batch augmentation: images on ``device``, labels on the host.

    imgs: [B, H, W, 3] uint8 or float32 numpy; cors: list of (2N, 2)
    corner arrays. ``wire``: "uint8" uploads the pixels; "dct" / "dct4"
    pack them on the host (ops/dct.py) and decode on the device.
    Returns (aug_imgs [B, H, W, 3] float32 on ``device``, aug_cors list,
    params list).
    """
    B = imgs.shape[0]
    ps = [sample_aug_params(rng, cors[b], W, **flags) for b in range(B)]
    vec = lambda k, dtype: torch.tensor(  # noqa: E731
        [p[k] for p in ps], dtype=dtype, device=device)
    args = (vec("kx", torch.float32), vec("ky", torch.float32),
            vec("flip", torch.bool), vec("dx", torch.int64),
            vec("p", torch.float32))
    if wire in ("dct", "dct4"):
        imgs = np.asarray(imgs)
        if imgs.dtype != np.uint8:
            imgs = np.clip(np.rint(imgs * 255.0), 0, 255).astype(np.uint8)
        pack, unpack = ((_dct.pack_dct4, _dct.unpack_dct4_to_rgb)
                        if wire == "dct4"
                        else (_dct.pack_dct, _dct.unpack_dct_to_rgb))
        # decoded on the device, then warped
        rgb = unpack(torch.from_numpy(pack(imgs)).to(device), H, W)
    elif wire == "uint8":
        rgb = torch.from_numpy(np.asarray(imgs)).to(device)
    else:
        raise ValueError(f"unknown training wire {wire!r}")
    out = augment_images(rgb, *args)
    aug_cors = [transform_corners(cors[b], ps[b], W) for b in range(B)]
    return out, aug_cors, ps
