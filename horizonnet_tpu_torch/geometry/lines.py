"""Great-circle boundary tracing between layout corners (host numpy).

Copy of horizonnet_tpu/geometry/lines.py (reference misc/panostretch.py:
51-78, dataset.py:137-169): the per-column 1D boundary of a corner list,
for the training labels.
"""

import numpy as np

from ..utils import profiling
from .equirect_host import coorx2u, coory2v, uv2xy, v2coory


def pano_connect_points(p1, p2, z=-50, w=1024, h=512):
    """Trace the equirect curve of the 3D segment between two corners.

    The two corners are lifted to the horizontal plane at height ``z``; the
    straight 3D segment between them projects to a curve on the pano,
    sampled at every integer column between them (wrapping across the seam
    when the short way around crosses it). Returns (N, 2) (col, row).
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    if p1[0] == p2[0]:
        return np.array([p1, p2], np.float32)

    u1, v1 = coorx2u(p1[0], w), coory2v(p1[1], h)
    u2, v2 = coorx2u(p2[0], w), coory2v(p2[1], h)
    x1, y1 = uv2xy(u1, v1, z)
    x2, y2 = uv2xy(u2, v2, z)

    if abs(p1[0] - p2[0]) < w / 2:
        pstart = np.ceil(min(p1[0], p2[0]))
        pend = np.floor(max(p1[0], p2[0]))
    else:
        pstart = np.ceil(max(p1[0], p2[0]))
        pend = np.floor(min(p1[0], p2[0]) + w)
    coorxs = (np.arange(pstart, pend + 1) % w).astype(np.float64)

    vx, vy = x2 - x1, y2 - y1
    us = coorx2u(coorxs, w)
    # each column's vertical plane (azimuth u) meets the segment where
    # tan(u) = (y1 + t vy) / (x1 + t vx)
    ps = (np.tan(us) * x1 - y1) / (vy - np.tan(us) * vx)
    cs = np.sqrt((x1 + ps * vx) ** 2 + (y1 + ps * vy) ** 2)
    vs = np.arctan2(z, cs)
    coorys = v2coory(vs, h)
    return np.stack([coorxs, coorys], axis=-1)


def sort_xy_filter_unique(xs, ys, y_small_first=True):
    """Sort boundary samples by x and keep one per column: the ceiling
    the smaller y, the floor the larger (a y tie-break in the sort key,
    as the reference). Ref: dataset.py:162-169."""
    xs, ys = np.array(xs), np.array(ys)
    idx_sort = np.argsort(xs + ys / ys.max() * (int(y_small_first) * 2 - 1))
    xs, ys = xs[idx_sort], ys[idx_sort]
    _, idx_unique = np.unique(xs, return_index=True)
    xs, ys = xs[idx_unique], ys[idx_unique]
    if not np.all(np.diff(xs) > 0):
        raise ValueError("boundary columns are not increasing")
    return xs, ys


def cor_2_1d(cor, H, W):
    """Corner list -> per-column (2, W) ceiling/floor boundary in radians.

    Rows of ``cor`` alternate ceiling/floor corners of each wall junction;
    the walls are traced at z=-50 (ceiling) and z=50 (floor), merged,
    deduplicated and interpolated periodically over the W columns, then
    turned into down-positive latitude. Ref: dataset.py:137-159. Traced
    as the span ``labels.bon`` (utils/profiling.py).
    """
    with profiling.span("labels.bon"):
        bon_ceil_x, bon_ceil_y = [], []
        bon_floor_x, bon_floor_y = [], []
        n_cor = len(cor)
        for i in range(n_cor // 2):
            xys = pano_connect_points(cor[i * 2], cor[(i * 2 + 2) % n_cor],
                                      z=-50, w=W, h=H)
            bon_ceil_x.extend(xys[:, 0])
            bon_ceil_y.extend(xys[:, 1])
        for i in range(n_cor // 2):
            xys = pano_connect_points(cor[i * 2 + 1], cor[(i * 2 + 3) % n_cor],
                                      z=50, w=W, h=H)
            bon_floor_x.extend(xys[:, 0])
            bon_floor_y.extend(xys[:, 1])
        bon_ceil_x, bon_ceil_y = sort_xy_filter_unique(
            bon_ceil_x, bon_ceil_y, y_small_first=True)
        bon_floor_x, bon_floor_y = sort_xy_filter_unique(
            bon_floor_x, bon_floor_y, y_small_first=False)
        bon = np.zeros((2, W))
        bon[0] = np.interp(np.arange(W), bon_ceil_x, bon_ceil_y, period=W)
        bon[1] = np.interp(np.arange(W), bon_floor_x, bon_floor_y, period=W)
        return ((bon + 0.5) / H - 0.5) * np.pi
