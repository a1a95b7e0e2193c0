"""The general layout's host tail (numpy): the reference's frozen copy.

From each pano's candidate summary (peak columns, per-(segment, axis)
vote fits, scores, L1s and means, z1, the cuboid fallback) to its corner
list, as the published postprocess commits walls (misc/post_proc.py:
241-359, inference.py:104-141): the axis pick, the greedy commitment
ring with forced alternation, the plan's validity check and the cuboid
fallback when the plan self-intersects.
"""

import dataclasses
import math
import sys

import numpy as np

PI = math.pi


def coory2v_up(y, h=512):
    """Pixel row -> up-positive latitude. Ref: misc/post_proc.py:26."""
    return -((y + 0.5) / h - 0.5) * PI


def coorx2u(x, w=1024):
    """Pixel column -> longitude. Ref: misc/panostretch.py:28."""
    return ((x + 0.5) / w - 0.5) * (2 * PI)


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


def x_u_solve_y(x, u, floorW=1024, floorH=512):
    """Plan y where the ray at longitude u meets the wall x = const.
    Ref: misc/post_proc.py:43-45."""
    c = (x - floorW / 2 + 0.5) / np.sin(u)
    return -c * np.cos(u) + floorH / 2 - 0.5


def y_u_solve_x(y, u, floorW=1024, floorH=512):
    """Plan x where the ray at longitude u meets the wall y = const.
    Ref: misc/post_proc.py:48-50."""
    c = -(y - floorH / 2 + 0.5) / np.cos(u)
    return c * np.sin(u) + floorW / 2 - 0.5


def infer_coory(coory0, h, z0=50, coorH=512):
    """Row of the plane at z0+h implied by the boundary rows on plane z0.
    Ref: misc/post_proc.py:126-131."""
    v0 = coory2v_up(np.asarray(coory0), coorH)
    c0 = z0 / np.tan(v0)
    v1 = np.arctan2(z0 + h, c0)
    return (-v1 / PI + 0.5) * coorH - 0.5


_EPS = 1e-12


def polygon_area(pts):
    """Unsigned shoelace area of a closed polygon given as (N, 2)."""
    pts = np.asarray(pts, np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


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


@dataclasses.dataclass
class Wall:
    """One axis-aligned wall of the plan-view layout ring.

    ``axis`` 0 means the wall lies on a plan line x = ``value``; axis 1
    means y = ``value``. ``seg`` is the source column segment (-1 for
    walls synthesized during commitment), ``u0``/``u1`` the azimuths of
    the segment's edge columns. ``origin`` records how the wall got its
    final shape: "vote", "flipped" (axis forced to alternate) or
    "inferred" (synthesized from a committed neighbour's edge azimuth).
    """

    axis: int
    value: float
    score: float = 0.0
    seg: int = -1
    u0: float = -1.0
    u1: float = -1.0
    pending: bool = False
    origin: str = "vote"

    def corner_wall_at(self, u: float) -> "Wall":
        """The perpendicular wall through this wall's point at azimuth u
        (ref misc/post_proc.py:272-276)."""
        if self.axis == 0:
            return Wall(axis=1, value=x_u_solve_y(self.value, u),
                        origin="inferred")
        return Wall(axis=0, value=y_u_solve_x(self.value, u),
                    origin="inferred")


class _GreedyRing:
    """State machine committing a ring of candidate walls one at a time.

    ``run`` repeatedly commits the highest-score pending wall and
    reconciles it with its already-committed ring neighbours so wall axes
    alternate, with three moves in this priority:

    - DEFER:  conflict with one committed neighbour -> push the wall back
      to pending at score - 100; a second conflict (score < -1) triggers
      INSERT instead.
    - INSERT: synthesize the perpendicular wall implied by the committed
      neighbour's edge azimuth next to it (a new corner).
    - RESOLVE (both neighbours committed): three same-axis walls in a row
      flip the middle one (re-voting its value on the new axis); when the
      neighbours' axes differ the wall is replaced by the two walls its
      neighbours imply.

    Commit order, tie-breaks, penalties and insertion positions track the
    reference greedy (misc/post_proc.py:241-334).
    """

    def __init__(self, walls, seg_mean):
        """``seg_mean(seg, axis)`` -> mean plan coordinate of a segment's
        samples on one axis (the flip re-vote value); the serving path
        reads the means the device fit computed."""
        self.walls = list(walls)
        self._seg_mean = seg_mean

    def run(self):
        while True:
            i = self._best_pending()
            if i is None:
                return self.walls
            self.walls[i].pending = False
            self._reconcile(i)

    def _best_pending(self):
        """Highest-score pending wall; lowest index breaks ties."""
        best = None
        for i, w in enumerate(self.walls):
            if w.pending and (best is None
                              or w.score > self.walls[best].score):
                best = i
        return best

    def _reconcile(self, i):
        walls = self.walls
        prv = walls[(i - 1) % len(walls)]
        nxt = walls[(i + 1) % len(walls)]

        if prv.pending and nxt.pending:
            return  # neighbours unknown yet: nothing to reconcile

        if prv.pending or nxt.pending:
            committed = nxt if prv.pending else prv
            if committed.axis != walls[i].axis:
                return  # alternates fine
            if walls[i].score >= -1:
                # DEFER: retry later at a penalized score
                walls[i].pending = True
                walls[i].score -= 100
            elif not prv.pending:
                # INSERT before i, at prv's trailing edge azimuth
                walls.insert(i, prv.corner_wall_at(prv.u1))
            else:
                # INSERT after i, at nxt's leading edge azimuth
                walls.insert((i + 1) % len(walls),
                             nxt.corner_wall_at(nxt.u0))
            return

        # RESOLVE: both neighbours committed
        if prv.axis == nxt.axis:
            if walls[i].axis == prv.axis:
                # three same-axis walls in a row: flip the middle one and
                # re-vote its value on the new axis (plain segment mean)
                w = walls[i]
                w.axis = (w.axis + 1) % 2
                w.origin = "flipped"
                w.value = self._seg_mean(w.seg, w.axis)
        else:
            # neighbours differ: this span must contain a corner; replace
            # it with the two walls the neighbours' edge azimuths imply
            self.walls[i:i + 1] = [prv.corner_wall_at(prv.u1),
                                   nxt.corner_wall_at(nxt.u0)]


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def unpack_general_outputs(packed):
    """Host twin of device.pack_general_outputs: ONE [B, 9K+17] float32
    array (numpy or a tensor on any device) -> (locs, fit, score, l1,
    mean, z1, cuboid_cor_id), K inferred from the width."""
    packed = _host(packed).astype(np.float32)
    B, D = packed.shape
    K = (D - 17) // 9
    if 9 * K + 17 != D:
        raise ValueError(f"packed width {D} is not 9K + 17")
    locs = packed[:, :K].astype(np.int32)
    o = K
    planes = []
    for _ in range(4):                       # fit, score, l1, mean
        planes.append(packed[:, o:o + 2 * K].reshape(B, K, 2))
        o += 2 * K
    z1 = packed[:, o]
    cub = packed[:, o + 1:].reshape(B, 8, 2)
    return (locs, *planes, z1, cub)


def corners_from_walls(walls, z1, z0=50.0, coorW=1024, coorH=512):
    """Committed wall ring -> normalized uv corner list (ceiling/floor
    interleaved), the tail of the reference postprocess (inference.py:
    129-141 + misc/post_proc.py:349-359)."""
    cor = []
    for j in range(len(walls)):
        nxt = (j + 1) % len(walls)
        if walls[j].axis == 1:
            cor.append((walls[nxt].value, walls[j].value))
        else:
            cor.append((walls[j].value, walls[nxt].value))
    cor = xy2coor(np.array(cor), z0, coorW, coorH)
    cor = np.roll(cor, -2 * cor[::2, 0].argmin(), axis=0)

    cor = np.hstack([cor, infer_coory(cor[:, 1], z1 - z0, z0,
                                      coorH=coorH)[:, None]])
    cor_id = np.zeros((len(cor) * 2, 2), np.float32)
    for j in range(len(cor)):
        cor_id[j * 2] = cor[j, 0], cor[j, 1]
        cor_id[j * 2 + 1] = cor[j, 0], cor[j, 2]
    cor_id[:, 0] /= coorW
    cor_id[:, 1] /= coorH
    return cor_id


def general_from_candidates(locs, fit, score, l1, mean, z1, cuboid_cor_id,
                            coorW=1024, coorH=512, z0=50.0):
    """One pano's candidate summary -> (cor_id, z0, z1).

    locs [K] int32 (-1 padding); fit/score/l1/mean [K, 2]; z1 scalar;
    cuboid_cor_id [8, 2], used as it is when the greedy gives an invalid
    (self-intersecting) plan or fewer than 2 corners were found.
    """
    z1 = float(z1)
    xs = locs[locs >= 0]
    if len(xs) < 2:
        return np.asarray(cuboid_cor_id), z0, z1

    walls = []
    n = len(xs)
    for j in range(n):
        # the host voter's axis pick: higher score wins, lower L1 breaks
        # ties, y on a full tie
        if (score[j, 0], -l1[j, 0]) > (score[j, 1], -l1[j, 1]):
            axis = 0
        else:
            axis = 1
        walls.append(Wall(axis=axis, value=float(fit[j, axis]),
                          score=float(score[j, axis]), seg=j,
                          u0=coorx2u(xs[(j - 1) % n], coorW),
                          u1=coorx2u(xs[j], coorW), pending=True))
    walls = _GreedyRing(
        walls, lambda seg, axis: float(mean[seg, axis])).run()

    # the reference's self-intersection guard (inference.py:114-126)
    xy2d = np.zeros((len(walls), 2), np.float32)
    for i in range(len(walls)):
        xy2d[i, walls[i].axis] = walls[i].value
        xy2d[i, walls[i - 1].axis] = walls[i - 1].value
    if not polygon_is_valid(xy2d):
        print("Fail to generate valid general layout!! "
              "Generate cuboid as fallback.", file=sys.stderr)
        return np.asarray(cuboid_cor_id), z0, z1

    return corners_from_walls(walls, z1, z0, coorW, coorH), z0, z1


def _finish_alternating_group(bs, nb, axis, fit, z1, cub, coorW, coorH,
                              z0, results):
    """Vectorized tail for the panos ``bs`` that share wall count ``nb``
    and whose candidate axes already alternate around the ring.

    On an alternating even ring the greedy commitment is the identity (no
    DEFER, INSERT or RESOLVE fires), so the tail is elementwise numpy over
    the group: plan assembly, the validity check and the corner
    back-projection, with the scalar path's dtypes and operation order
    (bit-identical to general_from_candidates).
    """
    G = len(bs)
    ax = axis[bs, :nb]                                       # [G, nb]
    val = np.take_along_axis(fit[bs, :nb].astype(np.float64),
                             ax[..., None], -1)[..., 0]      # [G, nb] f64

    # plan ring (float32, as the scalar path builds it) and its validity
    gi = np.arange(G)[:, None]
    wi = np.arange(nb)[None, :]
    xy2d = np.zeros((G, nb, 2), np.float32)
    xy2d[gi, wi, ax] = val
    xy2d[gi, wi, 1 - ax] = np.roll(val, 1, axis=1)           # walls[i-1]
    ok = polygon_is_valid_batch(xy2d)

    # corner back-projection (corners_from_walls, batched)
    val_n = np.roll(val, -1, axis=1)                         # walls[j+1]
    corx = np.where(ax == 1, val_n, val)
    cory = np.where(ax == 1, val, val_n)
    cor = xy2coor(np.stack([corx, cory], -1), z0, coorW, coorH)
    shift = cor[:, ::2, 0].argmin(axis=1)
    order = (wi + 2 * shift[:, None]) % nb
    cor = np.take_along_axis(cor, order[..., None], axis=1)
    z1g = z1[bs].astype(np.float64)
    fy = infer_coory(cor[..., 1], z1g[:, None] - z0, z0, coorH=coorH)
    cor_id = np.zeros((G, nb * 2, 2), np.float32)
    cor_id[:, 0::2] = cor
    cor_id[:, 1::2, 0] = cor[..., 0]
    cor_id[:, 1::2, 1] = fy
    cor_id[..., 0] /= coorW
    cor_id[..., 1] /= coorH

    for g, b in enumerate(bs):
        if ok[g]:
            results[b] = (cor_id[g], z0, float(z1g[g]))
        else:
            print("Fail to generate valid general layout!! "
                  "Generate cuboid as fallback.", file=sys.stderr)
            results[b] = (np.asarray(cub[b]), z0, float(z1g[g]))


def finish_general_batch(outputs, coorW=1024, coorH=512, z0=50.0):
    """Batch tail: the packed [B, 9K+17] device output (or the 7-tuple
    postprocess_general_batch returns) -> list of (cor_id, z0, z1).

    Panos whose candidate axes already alternate (the common Manhattan
    case) are finished in one vectorized numpy pass per wall-count group;
    the rest take the scalar greedy.
    """
    if isinstance(outputs, (tuple, list)):
        locs, fit, score, l1, mean, z1, cub = (_host(a) for a in outputs)
    else:
        locs, fit, score, l1, mean, z1, cub = unpack_general_outputs(
            outputs)
    B = len(locs)
    n = (locs >= 0).sum(-1)                                  # valid peaks
    # axis pick, the host voter's tuple-compare semantics
    pick_x = (score[..., 0] > score[..., 1]) | (
        (score[..., 0] == score[..., 1]) & (l1[..., 0] < l1[..., 1]))
    axis = np.where(pick_x, 0, 1)

    results = [None] * B
    groups = {}
    for b in range(B):
        nb = int(n[b])
        if nb >= 4 and nb % 2 == 0:
            ax = axis[b, :nb]
            if np.all(ax != np.roll(ax, 1)):
                groups.setdefault(nb, []).append(b)
                continue
        results[b] = general_from_candidates(
            locs[b], fit[b], score[b], l1[b], mean[b], z1[b], cub[b],
            coorW, coorH, z0)
    for nb, bs in groups.items():
        _finish_alternating_group(np.asarray(bs), nb, axis, fit, z1, cub,
                                  coorW, coorH, z0, results)
    return results
