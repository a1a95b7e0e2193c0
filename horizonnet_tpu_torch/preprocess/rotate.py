"""Panorama rotation by a 3x3 rotation (VP alignment warp) on the device.

Counterpart of horizonnet_tpu/preprocess/rotate.py. Reference behavior:
misc/pano_lsd_align.py:125-171 (rotatePanorama): for each output pixel,
compute its sphere direction, rotate back through R^-1 (R = inv(vp.T) when
built from a VP triplet), and sample the source pano bilinearly. One
device gather here, instead of the reference's border-padded host resample
(whose bottom-row wrap has a known copy-from-row-0 typo,
pano_lsd_align.py:163, not reproduced).
"""

import numpy as np
import torch

from ..ops.resample import bilinear_wrap_sample_one
from .views import preprocess_backend, _device


def _rotate_f32(img, Rinv):
    """Warp body shared by the float and uint8 entry points: ``img``
    [H, W(, C)] f32 and ``Rinv`` [3, 3] f32 on one device."""
    H, W = img.shape[:2]
    dev = img.device
    xs = ((torch.arange(1, W + 1, dtype=torch.float32, device=dev)
           - W / 2 - 0.5) / W * 2 * np.pi)
    ys = -((torch.arange(1, H + 1, dtype=torch.float32, device=dev)
            - H / 2 - 0.5) / H * np.pi)
    u = xs[None, :].expand(H, W)
    v = ys[:, None].expand(H, W)
    # planeID=1 sphere direction
    x = torch.cos(v) * torch.sin(u)
    y = torch.cos(v) * torch.cos(u)
    z = torch.sin(v)
    xyz = torch.stack([x, y, z], -1)            # [H, W, 3]
    # old = Rinv @ new per pixel, as a broadcast product and a sum over
    # the 3 axes: a matmul may run on TF32 when the process allows it, and
    # a bf16-like pass costs ~0.3 px of warp accuracy (JAX runs this
    # product at Precision.HIGHEST for the same reason)
    old = (xyz[..., None, :] * Rinv).sum(-1)    # [H, W, 3]
    ox, oy, oz = old[..., 0], old[..., 1], old[..., 2]
    norm_xy = torch.clamp(torch.sqrt(ox ** 2 + oy ** 2), min=1e-6)
    norm = torch.sqrt(ox ** 2 + oy ** 2 + oz ** 2)
    ov = torch.arcsin(torch.clamp(oz / norm, -1, 1))
    ou = torch.arcsin(torch.clamp(ox / norm_xy, -1, 1))
    ou = torch.where((oy < 0) & (ou >= 0), np.pi - ou, ou)
    ou = torch.where((oy < 0) & (ou < 0), -np.pi - ou, ou)
    Px = (ou + np.pi) / (2 * np.pi) * W + 0.5
    Py = (-ov + np.pi / 2) / np.pi * H + 0.5
    return bilinear_wrap_sample_one(img, Py - 1.0, Px - 1.0)


def _rinv(vp, R, device):
    if R is None:
        R = np.linalg.inv(np.asarray(vp, np.float64).T)
    return torch.as_tensor(np.linalg.inv(R).astype(np.float32),
                           device=device)


def rotate_panorama(img, vp=None, R=None, backend=None, device=None):
    """img: [H, W(, C)]; vp: (3,3) VP rows or R: explicit rotation.
    Returns f32 numpy of img's shape, warped on the host or (device
    backend) on ``device``, default CUDA."""
    if preprocess_backend(backend) == "host":
        from .host_resample import rotate_panorama_host
        return rotate_panorama_host(img, vp=vp, R=R)
    device = _device(device)
    img = torch.as_tensor(np.asarray(img, np.float32)).to(device)
    return _rotate_f32(img, _rinv(vp, R, device)).cpu().numpy()


def rotate_panorama_uint8(img_u8, vp=None, R=None, backend=None,
                          device=None):
    """uint8-in / uint8-out VP alignment warp: [H, W(, C)] 0..255.

    The device backend uploads uint8, keeps the f32 interpolation and the
    final ``floor`` and clip on the device, and downloads uint8: 1 byte a
    channel each way instead of 4 (the PNGs the preprocess CLI reads and
    writes are uint8 anyway). Values match the float path + host
    quantization except for the rare interpolated pixel landing within f32
    rounding of an integer boundary (+-1 LSB).
    """
    if preprocess_backend(backend) == "host":
        from .host_resample import rotate_panorama_uint8_host
        return rotate_panorama_uint8_host(img_u8, vp=vp, R=R)
    device = _device(device)
    img = torch.as_tensor(np.asarray(img_u8, np.uint8)).to(device)
    out = _rotate_f32(img.float(), _rinv(vp, R, device))
    return torch.clamp(torch.floor(out), 0, 255).to(torch.uint8).cpu() \
        .numpy()
