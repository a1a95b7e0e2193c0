"""Ground-truth label synthesis from corner lists (host numpy).

Copy of horizonnet_tpu/data/labels.py (reference dataset.py:107-208 and
misc/panostretch.py:105-115).
"""

import numpy as np

from ..geometry.equirect_host import (coorx2u, coory2v, u2coorx, uv2xy,
                                      v2coory)
from ..geometry.polygon import point_segments_intersect


def find_occlusion(coor, w=1024, h=512):
    """Mark ceiling corners whose camera ray crosses another wall: the plan
    segment camera -> corner against the polyline of the other corners in
    ring order after it. Ref: dataset.py:172-186 (shapely raycast)."""
    u = coorx2u(coor[:, 0], w)
    v = coory2v(coor[:, 1], h)
    x, y = uv2xy(u, v, z=-50)
    n = len(x)
    pts = np.stack([x, y], 1)
    occlusion = []
    for i in range(n):
        others = np.concatenate([pts[i + 1:], pts[:i]], 0)
        hit = point_segments_intersect(np.zeros((1, 2)), pts[i][None, :],
                                       others[:-1], others[1:])
        occlusion.append(bool(hit.any()))
    return np.array(occlusion)


def cor2xybound(cor, w=1024, h=512):
    """Plan-extent bounds that clip the stretch factors. Ref:
    dataset.py:189-208."""
    corU = cor[0::2]
    corB = cor[1::2]
    zU = -50
    u = coorx2u(corU[:, 0], w)
    vU = coory2v(corU[:, 1], h)
    vB = coory2v(corB[:, 1], h)
    x, y = uv2xy(u, vU, z=zU)
    c = np.sqrt(x ** 2 + y ** 2)
    zB = c * np.tan(vB)
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    S = 3 / abs(zB.mean() - zU)
    dx = [abs(xmin * S), abs(xmax * S)]
    dy = [abs(ymin * S), abs(ymax * S)]
    return min(dx), min(dy), max(dx), max(dy)


def stretched_corners(cor, kx, ky, w=1024, h=512):
    """Analytic corner transform under pano-stretch (kx, ky). Ref:
    misc/panostretch.py:105-115."""
    u0 = coorx2u(cor[:, 0], w)
    v0 = coory2v(cor[:, 1], h)
    u = np.arctan2(np.sin(u0) * ky / kx, np.cos(u0))
    C2 = (np.sin(u0) * ky) ** 2 + (np.cos(u0) * kx) ** 2
    v = np.arctan2(np.sin(v0), np.cos(v0) * np.sqrt(C2))
    return np.stack([u2coorx(u, w), v2coory(v, h)], axis=-1)


def corner_heatmap(corx, w=1024, p_base=0.96):
    """Per-column wall-wall probability: p_base ** circular distance to
    the nearest corner. Ref: dataset.py:107-120."""
    cols = np.arange(w)
    d = np.abs(corx[:, None] - cols[None, :])
    d = np.minimum(d, w - d)
    nearest = d.min(0) if len(corx) else np.full(w, np.inf)
    return (p_base ** nearest).astype(np.float32)
