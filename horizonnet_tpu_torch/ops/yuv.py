"""YUV 4:2:0 wire: host packing (numpy) and decode on the device (torch).

Counterpart of horizonnet_tpu/ops/yuv.py. Real pano sources are JPEG or
video, whose decoded form is YUV with 2x2-subsampled chroma: shipping
those planes costs half the bytes of RGB uint8. Full-range BT.601,
fixed-point forward on the host, float inverse on the device.

Wire layout: one uint8 array [B, 6, H/2, W/2]; planes 0..3 are the four
polyphase components of Y (Y[0::2, 0::2], Y[0::2, 1::2], Y[1::2, 0::2],
Y[1::2, 1::2]), planes 4 and 5 the subsampled Cb and Cr.
"""

import numpy as np
import torch


def pack_yuv420(rgb):
    """Host: RGB uint8 [B, H, W, 3] -> packed uint8 [B, 6, H/2, W/2],
    integer-only fixed-point BT.601 full range."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb {rgb.dtype} {rgb.shape} is not uint8 "
                         "[B, H, W, 3]")
    B, H, W, _ = rgb.shape
    if H % 2 or W % 2:
        raise ValueError(f"height {H} and width {W} must be even")
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = 128 + (((b - y) * 144 + 128) >> 8)
    cr = 128 + (((r - y) * 183 + 128) >> 8)

    out = np.empty((B, 6, H // 2, W // 2), np.uint8)
    out[:, 0] = y[:, 0::2, 0::2]
    out[:, 1] = y[:, 0::2, 1::2]
    out[:, 2] = y[:, 1::2, 0::2]
    out[:, 3] = y[:, 1::2, 1::2]
    # chroma: 2x2 box mean with rounding
    for k, c in ((4, cb), (5, cr)):
        out[:, k] = np.clip(
            (c[:, 0::2, 0::2] + c[:, 0::2, 1::2]
             + c[:, 1::2, 0::2] + c[:, 1::2, 1::2] + 2) >> 2, 0, 255)
    return out


def unpack_yuv420_to_rgb(packed):
    """Device: packed uint8 [B, 6, H/2, W/2] -> RGB float32 [B, H, W, 3]
    in [0, 1]; inverse of pack_yuv420 with nearest-neighbour chroma."""
    B, _, h2, w2 = packed.shape
    x = packed.float()
    # pixel-shuffle the four Y phases back to full resolution
    t = torch.stack([x[:, 0], x[:, 1], x[:, 2], x[:, 3]], -1)
    y = t.reshape(B, h2, w2, 2, 2).permute(0, 1, 3, 2, 4).reshape(
        B, 2 * h2, 2 * w2)
    cb = x[:, 4].repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    cr = x[:, 5].repeat_interleave(2, -2).repeat_interleave(2, -1) - 128.0
    # inverse of the fixed-point forward (256/183, 256/144 and the
    # 77/150/29 luma weights the host applied)
    r = y + cr * (256.0 / 183.0)
    b = y + cb * (256.0 / 144.0)
    g = (y - (77.0 / 256.0) * r - (29.0 / 256.0) * b) * (256.0 / 150.0)
    return torch.clamp(torch.stack([r, g, b], -1) / 255.0, 0.0, 1.0)
