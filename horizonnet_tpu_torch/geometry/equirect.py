"""Equirectangular pixel <-> angle <-> floor-plane transforms (tensors).

Counterpart of the device halves of horizonnet_tpu/geometry/equirect.py,
with the same conventions: pixel centers at +0.5, longitude u in
(-pi, pi], "up-positive" latitude for the Manhattan floor-plane fit
(reference misc/post_proc.py:22-72).
"""

import math

import torch

PI = math.pi


def coorx2u(x, w=1024):
    """Pixel column -> longitude. Ref: misc/post_proc.py:22."""
    return ((x + 0.5) / w - 0.5) * (2 * PI)


def coory2v_up(y, h=512):
    """Pixel row -> up-positive latitude. Ref: misc/post_proc.py:26."""
    return -((y + 0.5) / h - 0.5) * PI


def coor2xy(coor, z=50, coorW=1024, coorH=512, floorW=1024, floorH=512):
    """Pixel (col, row) pairs [..., 2] -> floor-plane image coords.
    Ref: misc/post_proc.py:30-40."""
    u = coorx2u(coor[..., 0], coorW)
    v = coory2v_up(coor[..., 1], coorH)
    c = z / torch.tan(v)
    x = c * torch.sin(u) + floorW / 2 - 0.5
    y = -c * torch.cos(u) + floorH / 2 - 0.5
    return torch.stack([x, y], dim=-1)


def xy2coor(xy, z=50, coorW=1024, coorH=512, floorW=1024, floorH=512):
    """Floor-plane image coords -> pixel (col, row). Ref: post_proc.py:53-66."""
    x = xy[..., 0] - floorW / 2 + 0.5
    y = xy[..., 1] - floorH / 2 + 0.5
    u = torch.atan2(x, -y)
    v = torch.atan(z / torch.sqrt(x ** 2 + y ** 2))
    coorx = (u / (2 * PI) + 0.5) * coorW - 0.5
    coory = (-v / PI + 0.5) * coorH - 0.5
    return torch.stack([coorx, coory], dim=-1)


def infer_coory(coory0, h, z0=50, coorH=512):
    """Row of the plane at z0+h implied by the boundary rows on plane z0.
    Ref: misc/post_proc.py:126-131."""
    v0 = coory2v_up(coory0, coorH)
    c0 = z0 / torch.tan(v0)
    v1 = torch.atan2(z0 + h, c0)
    return (-v1 / PI + 0.5) * coorH - 0.5


def mean_percentile(vec, p1=25, p2=75, dim=-1):
    """Mean of the entries between the p1-th and p2-th percentiles along
    ``dim`` (numpy's "linear" percentiles). Ref: misc/post_proc.py:69-72."""
    vmin = torch.quantile(vec, p1 / 100, dim=dim, keepdim=True)
    vmax = torch.quantile(vec, p2 / 100, dim=dim, keepdim=True)
    mask = (vmin <= vec) & (vec <= vmax)
    return (torch.where(mask, vec, 0.0).sum(dim)
            / mask.sum(dim).clamp(min=1))
