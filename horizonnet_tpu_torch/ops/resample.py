"""Batched bilinear gather-resampling with periodic (wrap) addressing.

Counterpart of horizonnet_tpu/ops/resample.py, the replacement for
scipy.ndimage.map_coordinates(order=1, mode='wrap') that the reference
calls per channel on the host (misc/panostretch.py:99-102). Addressing
wraps with period N (the true equirect period), not scipy's N-1, as in
JAX (:13-17): the two differ only within one pixel of the seam.
"""

import torch


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


def bilinear_wrap_sample_one(img, coords_y, coords_x):
    """Sample one image ``img`` [H, W] or [H, W, C] at float coords of any
    matching shape S with periodic wrap. Returns S (+ [C]): the unbatched
    form of horizonnet_tpu/ops/resample.py, which the preprocess warps
    call, through the batched sampler above."""
    out = bilinear_wrap_sample(
        img.reshape(1, *img.shape[:2], -1), coords_y[None], coords_x[None])
    return out[0] if img.ndim == 3 else out[0, ..., 0]
