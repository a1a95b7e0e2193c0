"""3D convex polytope clipping and volume (Qhull replacement for eval).

Copy of horizonnet_tpu/geometry/polytope.py, host float64 numpy, with the
same clip order, so that volumes are equal to the bit. The reference
computes 3D IoU of cuboid layouts as volumes of halfspace intersections
via scipy's Qhull bindings (eval_cuboid.py:13-92). This module owns that
capability: an incremental convex-polytope clipper (start from a bounding
box, clip by each halfspace) plus divergence-theorem volume.

Halfspace format matches the reference: rows [nx, ny, nz, b] meaning the
feasible side is n . x + b <= 0, with the origin strictly inside.
"""

import numpy as np

_EPS = 1e-9


def _box_faces(r):
    """Axis-aligned cube [-r, r]^3 as 6 outward-oriented quad faces."""
    v = np.array([[sx, sy, sz] for sx in (-r, r) for sy in (-r, r) for sz in (-r, r)],
                 np.float64)
    # Each face: vertex indices ordered CCW when viewed from outside
    quads = [
        (0, 1, 3, 2),  # x = -r (outward -x)
        (4, 6, 7, 5),  # x = +r
        (0, 4, 5, 1),  # y = -r
        (2, 3, 7, 6),  # y = +r
        (0, 2, 6, 4),  # z = -r
        (1, 5, 7, 3),  # z = +r
    ]
    return [v[list(q)] for q in quads]


def _clip_face(face, n, b):
    """Clip one polygon face by halfspace n.x + b <= 0 (Sutherland-Hodgman).

    Returns (kept_polygon or None, list of boundary-crossing points).
    """
    d = face @ n + b
    if (d <= _EPS).all():
        return face, []
    if (d >= -_EPS).all():
        return None, []
    out, crossings = [], []
    k = len(face)
    for i in range(k):
        p0, p1 = face[i - 1], face[i]
        d0, d1 = d[i - 1], d[i]
        if d1 <= _EPS:
            if d0 > _EPS:
                t = d0 / (d0 - d1)
                x = p0 + t * (p1 - p0)
                out.append(x)
                crossings.append(x)
            out.append(p1)
        elif d0 <= _EPS:
            t = d0 / (d0 - d1)
            x = p0 + t * (p1 - p0)
            out.append(x)
            crossings.append(x)
    if len(out) < 3:
        return None, crossings
    return np.array(out), crossings


def _cap_face(points, n):
    """Order the cap vertices into a convex polygon with outward normal n."""
    pts = np.array(points, np.float64)
    # Deduplicate
    keep = []
    for p in pts:
        if not any(np.linalg.norm(p - q) < 1e-7 for q in keep):
            keep.append(p)
    if len(keep) < 3:
        return None
    pts = np.array(keep)
    c = pts.mean(0)
    n = n / np.linalg.norm(n)
    # Build an in-plane basis
    a = np.array([1.0, 0.0, 0.0])
    if abs(n[0]) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(n, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    ang = np.arctan2((pts - c) @ e2, (pts - c) @ e1)
    order = np.argsort(ang)
    pts = pts[order]
    # Ensure outward orientation: polygon normal (fan cross) along +n
    v1, v2 = pts[1] - pts[0], pts[2] - pts[0]
    if np.dot(np.cross(v1, v2), n) < 0:
        pts = pts[::-1]
    return pts


def clip_polytope(halfspaces, bound=1e4):
    """Intersect halfspaces [n | b] (n.x + b <= 0) into a face list.

    The origin must be interior (as in the reference construction,
    eval_cuboid.py:23-46). Returns a list of outward-oriented faces, or []
    if the intersection is empty/degenerate.
    """
    faces = _box_faces(bound)
    hs = np.asarray(halfspaces, np.float64)
    for row in hs:
        n, b = row[:3], row[3]
        norm = np.linalg.norm(n)
        if norm < _EPS:
            continue
        new_faces, crossings = [], []
        for f in faces:
            kept, cross = _clip_face(f, n, b)
            if kept is not None:
                new_faces.append(kept)
            crossings.extend(cross)
        if not new_faces:
            return []
        cap = _cap_face(crossings, n) if len(crossings) >= 3 else None
        if cap is not None:
            new_faces.append(cap)
        faces = new_faces
    return faces


def polytope_volume(faces):
    """Volume from outward-oriented faces via the divergence theorem."""
    vol = 0.0
    for f in faces:
        for i in range(1, len(f) - 1):
            vol += np.dot(f[0], np.cross(f[i], f[i + 1]))
    return vol / 6.0


def halfspace_intersection_volume(halfspaces, bound=1e4):
    """Volume of the intersection of halfspaces (origin interior)."""
    return polytope_volume(clip_polytope(halfspaces, bound))


def _tri2halfspace(pa, pb, p):
    """Halfspace through the triangle's plane keeping the origin inside.

    Ref: eval_cuboid.py:13-20.
    """
    v1 = pa - p
    v2 = pb - p
    vn = np.cross(v1, v2)
    if -vn @ p > 0:
        vn = -vn
    return np.concatenate([vn, [-vn @ p]])


def layout_halfspaces(xyz_floor, xyz_ceil):
    """6 halfspaces per corner from floor/ceiling rings (origin inside).

    Ref: eval_cuboid.py:23-46 (xyzlst2halfspaces).
    """
    xyz_floor = np.asarray(xyz_floor, np.float64)
    xyz_ceil = np.asarray(xyz_ceil, np.float64)
    N = xyz_floor.shape[0]
    halfspaces = []
    for i in range(N):
        last_i = (i - 1 + N) % N
        next_i = (i + 1) % N
        pf_a, pf_b, pf = xyz_floor[last_i], xyz_floor[next_i], xyz_floor[i]
        pc_a, pc_b, pc = xyz_ceil[last_i], xyz_ceil[next_i], xyz_ceil[i]
        halfspaces.append(_tri2halfspace(pf_a, pf_b, pf))
        halfspaces.append(_tri2halfspace(pf_a, pc, pf))
        halfspaces.append(_tri2halfspace(pc, pf_b, pf))
        halfspaces.append(_tri2halfspace(pc_a, pc_b, pc))
        halfspaces.append(_tri2halfspace(pc_a, pf, pc))
        halfspaces.append(_tri2halfspace(pf, pc_b, pc))
    return np.array(halfspaces)
