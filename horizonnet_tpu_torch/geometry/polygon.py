"""2D polygon geometry (host numpy): area, validity, intersection.

Copy of horizonnet_tpu/geometry/polygon.py, the shapely replacement of
the reference (dataset.py:172-186, inference.py:114-126,
eval_general.py:66-82): ``point_segments_intersect`` for the occlusion
labels; ``polygon_is_valid`` / ``polygon_is_valid_batch`` for the host
postprocess and the general-layout serving tail; and the exact
intersection area of two simple polygons (a signed triangle fan, each
triangle clipped convexly) with ``polygon_iou`` for the evals. For a
self-intersecting input the area degrades to the winding-weighted
overlap instead of raising.
"""

import warnings

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


def signed_polygon_area(pts):
    """Signed shoelace area (positive if counter-clockwise)."""
    pts = np.asarray(pts, np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _segments(pts):
    pts = np.asarray(pts, np.float64)
    return pts, np.roll(pts, -1, axis=0)


def polygon_is_valid(pts):
    """True iff the polygon ring is simple (no self-intersection) and has
    area. Adjacent edges sharing an endpoint do not count as crossing."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if n < 3 or polygon_area(pts) <= _EPS:
        return False
    a0, a1 = _segments(pts)
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


def _clip_convex(subject, cx0, cx1):
    """Sutherland-Hodgman: clip polygon ``subject`` by the half-plane to
    the left of the directed edge (cx0 -> cx1). Returns (M, 2), maybe
    empty."""
    out = []
    n = len(subject)
    ex, ey = cx1[0] - cx0[0], cx1[1] - cx0[1]

    def side(p):
        return ex * (p[1] - cx0[1]) - ey * (p[0] - cx0[0])

    for k in range(n):
        cur = subject[k]
        prv = subject[k - 1]
        sc, sp = side(cur), side(prv)
        if sc >= -_EPS:
            if sp < -_EPS:
                t = sp / (sp - sc)
                out.append(prv + t * (cur - prv))
            out.append(cur)
        elif sp >= -_EPS:
            t = sp / (sp - sc)
            out.append(prv + t * (cur - prv))
    return np.array(out) if out else np.zeros((0, 2))


def convex_intersection_area(p, q):
    """Area of intersection of two convex polygons (CCW order)."""
    r = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    for k in range(len(q)):
        if len(r) == 0:
            return 0.0
        r = _clip_convex(r, q[k - 1], q[k])
    if len(r) < 3:
        return 0.0
    return abs(signed_polygon_area(r))


def _fan_triangles(pts):
    """Decompose a polygon into centroid-fan triangles (each stored CCW)
    with their orientation signs."""
    pts = np.asarray(pts, np.float64)
    o = pts.mean(0)  # the centroid keeps the triangles well-conditioned
    tris, signs = [], []
    n = len(pts)
    for k in range(n):
        a, b = pts[k], pts[(k + 1) % n]
        s = 0.5 * ((a[0] - o[0]) * (b[1] - o[1])
                   - (a[1] - o[1]) * (b[0] - o[0]))
        if abs(s) <= _EPS:
            continue
        if s > 0:
            tris.append(np.array([o, a, b]))
            signs.append(1.0)
        else:
            tris.append(np.array([o, b, a]))
            signs.append(-1.0)
    return tris, signs


def _tri_tri_intersection_areas(tris, clip):
    """Areas of intersection of many CCW triangles [N, 3, 2] with one CCW
    triangle ``clip`` [3, 2]. The intersection of two convex polygons is
    the convex hull of the vertices of one inside the other and the
    edge-pair crossings: all <= 15 candidate points per pair, ordered by
    angle, then the shoelace."""
    N = len(tris)
    if N == 0:
        return np.zeros(0)

    def edges(poly):
        return poly, np.roll(poly, -1, axis=-2)

    def points_in_tri(pts, tri):
        # pts [..., K, 2], tri [..., 3, 2]: on or left of every CCW edge
        a, b = tri, np.roll(tri, -1, axis=-2)
        ex = (b[..., None, :, 0] - a[..., None, :, 0])
        ey = (b[..., None, :, 1] - a[..., None, :, 1])
        px = pts[..., :, None, 0] - a[..., None, :, 0]
        py = pts[..., :, None, 1] - a[..., None, :, 1]
        cross = ex * py - ey * px
        return (cross >= -_EPS).all(-1)

    cand = np.full((N, 15, 2), np.nan)
    # 1) triangle vertices inside clip
    m1 = points_in_tri(tris, clip[None])                  # [N, 3]
    cand[:, 0:3] = np.where(m1[..., None], tris, np.nan)
    # 2) clip vertices inside the triangles
    m2 = points_in_tri(np.broadcast_to(clip[None], (N, 3, 2)), tris)
    cand[:, 3:6] = np.where(m2[..., None], clip[None], np.nan)
    # 3) all 9 edge-pair crossings
    a0, a1 = edges(tris)                                   # [N, 3, 2] each
    b0, b1 = edges(clip)                                   # [3, 2]
    A0 = a0[:, :, None, :]
    A1 = a1[:, :, None, :]
    B0 = b0[None, None, :, :]
    B1 = b1[None, None, :, :]
    d = A1 - A0
    e = B1 - B0
    denom = d[..., 0] * e[..., 1] - d[..., 1] * e[..., 0]  # [N, 3, 3]
    f = B0 - A0
    # parallel or degenerate edge pairs never cross: mask the denominator
    # before dividing, so no inf or NaN is produced
    denom_ok = np.abs(denom) > _EPS
    safe_denom = np.where(denom_ok, denom, 1.0)
    t = (f[..., 0] * e[..., 1] - f[..., 1] * e[..., 0]) / safe_denom
    s = (f[..., 0] * d[..., 1] - f[..., 1] * d[..., 0]) / safe_denom
    hit = denom_ok & (t >= -_EPS) & (t <= 1 + _EPS) \
        & (s >= -_EPS) & (s <= 1 + _EPS)
    pt = A0 + np.where(hit, t, 0.0)[..., None] * d
    pt = np.where(hit[..., None], pt, np.nan)
    cand[:, 6:15] = pt.reshape(N, 9, 2)

    # order the candidates by angle around their mean, shoelace the ring
    valid = ~np.isnan(cand[..., 0])
    n_valid = valid.sum(1)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ctr = np.nanmean(np.where(valid[..., None], cand, np.nan), axis=1)
    ang = np.arctan2(cand[..., 1] - ctr[:, None, 1],
                     cand[..., 0] - ctr[:, None, 0])
    ang = np.where(valid, ang, np.inf)                     # NaNs sort last
    order = np.argsort(ang, axis=1)
    ring = np.take_along_axis(cand, order[..., None], axis=1)
    ring_valid = np.take_along_axis(valid, order, axis=1)
    # invalid slots take the first valid point, so they add no area
    first = ring[:, 0:1]
    ringf = np.where(ring_valid[..., None], ring, first)
    x, y = ringf[..., 0], ringf[..., 1]
    x2 = np.roll(x, -1, axis=1)
    y2 = np.roll(y, -1, axis=1)
    area = 0.5 * np.abs((x * y2 - y * x2).sum(1))
    area = np.where(n_valid >= 3, area, 0.0)
    return area


def polygon_intersection_area(p, q):
    """Intersection area of two simple polygons (any orientation).

    For a simple CCW polygon P, 1_P = sum_i s_i 1_{T_i} over its signed
    fan triangles, so area(P & Q) = sum_ij s_i t_j area(T_i & U_j); each
    term is a convex triangle-triangle clip, all of P's triangles against
    one of Q's at a time.
    """
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    if len(p) < 3 or len(q) < 3:
        return 0.0
    # CCW, so the indicators sum to +1 inside
    if signed_polygon_area(p) < 0:
        p = p[::-1]
    if signed_polygon_area(q) < 0:
        q = q[::-1]
    tp, sp = _fan_triangles(p)
    tq, sq = _fan_triangles(q)
    if not tp or not tq:
        return 0.0
    tris = np.stack(tp)                     # [N, 3, 2], each CCW
    signs_p = np.asarray(sp)
    total = 0.0
    for uj, tj in zip(tq, sq):
        areas = _tri_tri_intersection_areas(tris, uj)
        total += tj * float((signs_p * areas).sum())
    return max(total, 0.0)


def polygon_iou(p, q):
    """2D IoU of two simple polygons (eval_general.py:77-81)."""
    area_p = polygon_area(p)
    area_q = polygon_area(q)
    inter = polygon_intersection_area(p, q)
    denom = area_p + area_q - inter
    if denom <= 0:
        return 0.0
    return inter / denom
