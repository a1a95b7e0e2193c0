"""Synthetic rooms and their labels (host numpy): the traffic of the
training cell and the reference's labels.

Frozen copies of the published label geometry (HorizonNet dataset.py,
misc/panostretch.py, misc/post_proc.py): equirect conversions, the
per-column boundary traced between corners (``cor_2_1d``), the corner
heat map, the occlusion test and the pano-stretch of corners; and the
synthetic room generator (``synth_room``): a cuboid or L-shaped plan seen
from inside, painted in shaded bands with darkened corner columns, with
its exact corner list.
"""

import math

import numpy as np

PI = math.pi

def coorx2u(x, w=1024):
    """Pixel column -> longitude. Ref: misc/panostretch.py:28."""
    return ((x + 0.5) / w - 0.5) * (2 * PI)


def coory2v(y, h=512):
    """Pixel row -> down-positive latitude. Ref: misc/panostretch.py:32."""
    return ((y + 0.5) / h - 0.5) * PI


def coory2v_up(y, h=512):
    """Pixel row -> up-positive latitude. Ref: misc/post_proc.py:26."""
    return -((y + 0.5) / h - 0.5) * PI


def u2coorx(u, w=1024):
    """Longitude -> pixel column. Ref: misc/panostretch.py:36."""
    return (u / (2 * PI) + 0.5) * w - 0.5


def v2coory(v, h=512):
    """Down-positive latitude -> pixel row. Ref: misc/panostretch.py:40."""
    return (v / PI + 0.5) * h - 0.5


def uv2xy(u, v, z=-50):
    """(u, down-positive v) on a horizontal plane at height z -> plan
    (x, y) = c (cos u, sin u), c = z / tan(v). Ref: panostretch.py:44-48."""
    c = z / np.tan(v)
    return c * np.cos(u), c * np.sin(u)


def xy2coor(xy, z=50, coorW=1024, coorH=512, floorW=1024, floorH=512):
    """Floor-plane image coords -> pixel (col,row). Ref: post_proc.py:53-66."""
    xy = np.asarray(xy)
    x = xy[..., 0] - floorW / 2 + 0.5
    y = xy[..., 1] - floorH / 2 + 0.5
    u = np.arctan2(x, -y)
    v = np.arctan(z / np.sqrt(x ** 2 + y ** 2))
    coorx = (u / (2 * PI) + 0.5) * coorW - 0.5
    coory = (-v / PI + 0.5) * coorH - 0.5
    return np.stack([coorx, coory], axis=-1)


def infer_coory(coory0, h, z0=50, coorH=512):
    """Row of the plane at z0+h implied by the boundary rows on plane z0.
    Ref: misc/post_proc.py:126-131."""
    v0 = coory2v_up(np.asarray(coory0), coorH)
    c0 = z0 / np.tan(v0)
    v1 = np.arctan2(z0 + h, c0)
    return (-v1 / PI + 0.5) * coorH - 0.5


_EPS = 1e-12


def point_segments_intersect(a0, a1, b0, b1):
    """Vectorized segment intersection test; inputs broadcast, returns a
    bool array. Segments intersect if they straddle each other or touch
    (collinear overlap counts)."""
    a0 = np.asarray(a0, np.float64)
    a1 = np.asarray(a1, np.float64)
    b0 = np.asarray(b0, np.float64)
    b1 = np.asarray(b1, np.float64)

    def cross(o, p, q):
        return (p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1]) - \
               (p[..., 1] - o[..., 1]) * (q[..., 0] - o[..., 0])

    d1 = cross(b0, b1, a0)
    d2 = cross(b0, b1, a1)
    d3 = cross(a0, a1, b0)
    d4 = cross(a0, a1, b1)

    straddle = ((d1 > _EPS) & (d2 < -_EPS) | (d1 < -_EPS) & (d2 > _EPS)) & \
               ((d3 > _EPS) & (d4 < -_EPS) | (d3 < -_EPS) & (d4 > _EPS))

    def on_seg(o, p, q, d):
        # q collinear with segment (o, p) and within its bounding box
        return (np.abs(d) <= _EPS) & \
            (q[..., 0] <= np.maximum(o[..., 0], p[..., 0]) + _EPS) & \
            (q[..., 0] >= np.minimum(o[..., 0], p[..., 0]) - _EPS) & \
            (q[..., 1] <= np.maximum(o[..., 1], p[..., 1]) + _EPS) & \
            (q[..., 1] >= np.minimum(o[..., 1], p[..., 1]) - _EPS)

    touch = on_seg(b0, b1, a0, d1) | on_seg(b0, b1, a1, d2) | \
        on_seg(a0, a1, b0, d3) | on_seg(a0, a1, b1, d4)
    return straddle | touch


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
    turned into down-positive latitude. Ref: dataset.py:137-159.
    """
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
    bon_ceil_x, bon_ceil_y = sort_xy_filter_unique(bon_ceil_x, bon_ceil_y,
                                                   y_small_first=True)
    bon_floor_x, bon_floor_y = sort_xy_filter_unique(bon_floor_x, bon_floor_y,
                                                     y_small_first=False)
    bon = np.zeros((2, W))
    bon[0] = np.interp(np.arange(W), bon_ceil_x, bon_ceil_y, period=W)
    bon[1] = np.interp(np.arange(W), bon_floor_x, bon_floor_y, period=W)
    return ((bon + 0.5) / H - 0.5) * np.pi


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


def synth_plan(rng, general_p=0.5):
    """Random room plan (plan-view pixel coords around the pano center)."""
    cx, cy = 512 - 0.5, 256 - 0.5
    w1, d1 = rng.uniform(5, 11), rng.uniform(4, 9)
    if rng.uniform() < general_p:
        wq = rng.uniform(1.5, w1 - 1.5)
        dq = rng.uniform(1.5, d1 - 1.5)
        plan = np.array([
            [cx - w1, cy - d1], [cx + w1, cy - d1], [cx + w1, cy + dq],
            [cx + wq, cy + dq], [cx + wq, cy + d1], [cx - w1, cy + d1]])
    else:
        plan = np.array([[cx - w1, cy - d1], [cx + w1, cy - d1],
                         [cx + w1, cy + d1], [cx - w1, cy + d1]])
    return plan


def synth_room(rng, H=512, W=1024, general_p=0.5):
    """One synthetic pano. Returns (img uint8 [H, W, 3], cor [N, 2]).

    ``cor`` is the GT corner list in pixel coords, ceiling/floor
    interleaved and ordered by x — the label_cor txt format of the
    reference datasets (README_PREPARE_DATASET.md layout).
    """
    plan = synth_plan(rng, general_p)
    z0 = 50.0
    z1 = -rng.uniform(30, 75)  # floor plane (demo room sits near -47)
    ceil = xy2coor(plan, z0, W, H)
    ceil = ceil[np.argsort(ceil[:, 0])]
    floor_y = infer_coory(ceil[:, 1], z1 - z0, z0, H)
    n = len(ceil)
    cor = np.empty((2 * n, 2), np.float32)
    cor[0::2] = ceil
    cor[1::2] = np.stack([ceil[:, 0], floor_y], -1)

    bon = cor_2_1d(cor, H, W)                     # [2, W] radians
    rows = ((bon / np.pi + 0.5) * H - 0.5)        # pixel rows
    ceil_row, floor_row = rows[0], rows[1]

    ys = np.arange(H)[:, None]
    above = ys < ceil_row[None, :]
    below = ys > floor_row[None, :]
    wall = ~(above | below)

    # Distinct, randomly colored bands with smooth shading gradients
    base = rng.uniform(60, 200, (3, 3))           # ceil / wall / floor
    img = np.zeros((H, W, 3))
    grad_v = np.linspace(0.75, 1.25, H)[:, None]
    img += above[..., None] * base[0] * grad_v[..., None]
    img += below[..., None] * base[2] * (2 - grad_v)[..., None]

    # Per-wall brightness from the segment id of each column
    seg = (np.arange(W)[:, None] >= ceil[:, 0][None, :]).sum(1) % n
    wall_gain = rng.uniform(0.6, 1.4, n)[seg][None, :, None]
    img += wall[..., None] * base[1] * wall_gain

    # Darkened corner columns (3 px) make the corner channel learnable
    for x in np.round(ceil[:, 0]).astype(int):
        sl = (np.arange(x - 1, x + 2) % W)
        img[:, sl] *= np.where(wall[:, sl, None], 0.45, 1.0)

    img += rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), cor
