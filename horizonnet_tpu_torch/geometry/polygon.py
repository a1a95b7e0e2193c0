"""2D segment intersection and polygon validity (host numpy).

Copy of horizonnet_tpu/geometry/polygon.py's ``point_segments_intersect``
(the reference's shapely raycast, dataset.py:172-186), used by the
occlusion labels, and of ``polygon_is_valid`` / ``polygon_is_valid_batch``
(shapely's ``is_valid`` for the plain rings of inference.py:114-126), used
by the general-layout serving tail.
"""

import numpy as np

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


def polygon_area(pts):
    """Unsigned shoelace area of a closed polygon given as (N, 2)."""
    pts = np.asarray(pts, np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def polygon_is_valid(pts):
    """True iff the polygon ring is simple (no self-intersection) and has
    area. Adjacent edges sharing an endpoint do not count as crossing."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if n < 3 or polygon_area(pts) <= _EPS:
        return False
    a0, a1 = pts, np.roll(pts, -1, axis=0)
    i, j = np.triu_indices(n, k=2)
    # the first and the last edge are adjacent across the wrap
    keep = ~((i == 0) & (j == n - 1))
    i, j = i[keep], j[keep]
    if len(i) == 0:
        return True
    hits = point_segments_intersect(a0[i], a1[i], a0[j], a1[j])
    return not bool(hits.any())


def polygon_is_valid_batch(pts):
    """``polygon_is_valid`` over a [G, n, 2] stack of equal-length rings
    -> [G] bool, with elementwise-identical products and thresholds."""
    pts = np.asarray(pts, np.float64)
    G, n = pts.shape[:2]
    if n < 3:
        return np.zeros(G, bool)
    x, y = pts[..., 0], pts[..., 1]
    x2 = np.roll(x, -1, axis=1)
    y2 = np.roll(y, -1, axis=1)
    ok = 0.5 * np.abs((x * y2 - y * x2).sum(-1)) > _EPS
    a0, a1 = pts, np.roll(pts, -1, axis=1)
    i, j = np.triu_indices(n, k=2)
    keep = ~((i == 0) & (j == n - 1))
    i, j = i[keep], j[keep]
    if len(i):
        hits = point_segments_intersect(a0[:, i], a1[:, i],
                                        a0[:, j], a1[:, j])
        ok &= ~hits.any(-1)
    return ok
