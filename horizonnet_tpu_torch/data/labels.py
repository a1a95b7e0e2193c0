"""Ground-truth label synthesis from corner lists (host numpy).

Copy of horizonnet_tpu/data/labels.py (reference dataset.py:107-208 and
misc/panostretch.py:105-115).
"""

import numpy as np

from ..geometry.equirect_host import (coorx2u, coory2v, u2coorx, uv2xy,
                                      v2coory)
from ..geometry.polygon import point_segments_intersect
from ..utils import profiling


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
    the nearest corner. Ref: dataset.py:107-120. Traced as the span
    ``labels.cor`` (utils/profiling.py)."""
    with profiling.span("labels.cor"):
        cols = np.arange(w)
        d = np.abs(corx[:, None] - cols[None, :])
        d = np.minimum(d, w - d)
        nearest = d.min(0) if len(corx) else np.full(w, np.inf)
        return (p_base ** nearest).astype(np.float32)


#: the camera's height above the floor, in metres (the evals' camera)
CAMERA_HEIGHT = 1.6


def horizon_depth(cor, h=512, w=1024, n=256, camera_height=CAMERA_HEIGHT):
    """LGT-Net's labels from a corner list (ceiling/floor pairs, pixel
    coords): (depth [n] float32, ratio float).

    Each floor corner k, at longitude u_k and down-positive latitude v_k,
    lies at distance r_k = camera_height / tan(v_k) on the floor plane, at
    p_k = r_k (cos u_k, sin u_k). The depth of column i is the distance
    along its centre longitude t_i = ((i + 0.5) / n - 0.5) 2 pi to the
    nearest crossing of the polygon of the p_k in ring order. The ratio
    is the mean over corners of the ceiling's height above the camera,
    r_k tan(-v^c_k) at the ceiling corner's latitude, over
    camera_height. Float64 inside. Traced as the span ``labels.depth``."""
    with profiling.span("labels.depth"):
        cor = np.asarray(cor, np.float64)
        u = coorx2u(cor[1::2, 0], w)
        r = camera_height / np.tan(coory2v(cor[1::2, 1], h))
        ratio = float(np.mean(r * np.tan(-coory2v(cor[0::2, 1], h)))
                      / camera_height)
        a = np.stack([r * np.cos(u), r * np.sin(u)], -1)     # [K, 2]
        d = np.roll(a, -1, 0) - a                            # edges a -> b
        t = (np.arange(n) + 0.5) / n * (2 * np.pi) - np.pi
        e = np.stack([np.cos(t), np.sin(t)], -1)             # [n, 2]
        cross = lambda p, q: p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]
        den = cross(e[:, None], d[None])                     # [n, K]
        with np.errstate(divide="ignore", invalid="ignore"):
            dist = cross(a, d)[None] / den
            s = cross(a[None], e[:, None]) / den
        hit = (np.abs(den) > 1e-12) & (s >= 0) & (s <= 1) & (dist > 0)
        depth = np.where(hit, dist, np.inf).min(1)
        return depth.astype(np.float32), ratio
