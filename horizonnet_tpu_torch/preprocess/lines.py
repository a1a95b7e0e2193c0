"""Line-segment lifting, merging, VP assignment, refitting, painting.

Copied from horizonnet_tpu/preprocess/lines.py (numpy; no torch).

Host-side numpy over at most a few thousand segments. Reference behavior:
misc/pano_lsd_align.py:273-436 (edgeFromImg2Pano, combineEdgesN),
715-801 (assignVanishingType, refitLineSegmentB, paintParameterLine).

Line parameterization: [nx ny nz planeID umin umax arclen score] where
(nx,ny,nz) is the great-circle normal and (umin, umax) the azimuth range
in turns (0..1) in the planeID convention.
"""

import numpy as np

from .sphere import (uv2xyzN, computeUVN, computeUVN_vec,
                     uv2xyzN_vec)


def lift_segments_to_sphere(seg_list, vx, vy, fov, im_hw):
    """Perspective-view segments -> sphere great-circle normals.

    seg_list: (N, >=5) rows [x1 y1 x2 y2 width ... score]; returns
    (N, 10) rows [normal(3) coord1(3) coord2(3) score].
    Ref: misc/pano_lsd_align.py:273-312.
    """
    if len(seg_list) == 0:
        return np.zeros((0, 10))
    imH, imW = im_hw
    R = (imW / 2) / np.tan(fov / 2)
    # tangent-plane origin on the sphere of radius R
    x0 = R * np.cos(vy) * np.sin(vx)
    y0 = R * np.cos(vy) * np.cos(vx)
    z0 = R * np.sin(vy)
    vecposX = np.array([np.cos(vx), -np.sin(vx), 0.0])
    vecposY = np.cross(np.array([x0, y0, z0]), vecposX)
    vecposY /= np.linalg.norm(vecposY)
    Xc = (imW - 1) / 2
    Yc = (imH - 1) / 2

    p1 = (seg_list[:, [0]] - Xc) * vecposX + (seg_list[:, [1]] - Yc) * vecposY
    p2 = (seg_list[:, [2]] - Xc) * vecposX + (seg_list[:, [3]] - Yc) * vecposY
    coord1 = p1 + [x0, y0, z0]
    coord2 = p2 + [x0, y0, z0]
    normal = np.cross(coord1, coord2)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    score = seg_list[:, [-1]]
    return np.hstack([normal, coord1, coord2, score])


def _range_intersects(r1, r2):
    """Do two (possibly seam-wrapping) turn-ranges overlap? Open overlap.

    Ref: pano_lsd_align.py:315-335.
    """
    def unwrap(r):
        if r[1] < r[0]:
            return [(r[0], 1.0), (0.0, r[1])]
        return [(r[0], r[1]), (0.0, 0.0)]

    for a in unwrap(r1):
        for b in unwrap(r2):
            if max(a[0], b[0]) < min(a[1], b[1]):
                return True
    return False


def _inside_range(pt, r):
    """Is turn-coordinate pt inside (possibly wrapping) range r?"""
    if r[1] > r[0]:
        return r[0] <= pt <= r[1]
    return (r[0] <= pt <= 1.0) or (0.0 <= pt <= r[1])


def segments_to_lines(arc_list):
    """(N,10) lifted segments -> (N,8) parameterized lines (vectorized).

    planeID picks the axis the normal is most aligned with (so u is
    well-conditioned). Ref: combineEdgesN's first half, :364-387.
    """
    from .sphere import xyz2uvN_vec

    n = len(arc_list)
    lines = np.zeros((n, 8))
    plane_ids = np.argmax(np.abs(arc_list[:, [2, 0, 1]]), axis=1) + 1
    lines[:, :3] = arc_list[:, :3]
    lines[:, 3] = plane_ids

    c1 = arc_list[:, 3:6]
    c2 = arc_list[:, 6:9]
    uv1 = xyz2uvN_vec(c1, plane_ids)[:, 0] + np.pi
    uv2 = xyz2uvN_vec(c2, plane_ids)[:, 0] + np.pi
    umin = np.minimum(uv1, uv2)
    umax = np.maximum(uv1, uv2)
    wrap = (umax - umin) > np.pi
    lines[:, 4] = np.where(wrap, umax, umin) / (2 * np.pi)
    lines[:, 5] = np.where(wrap, umin, umax) / (2 * np.pi)

    cosang = (c1 * c2).sum(1) / (np.linalg.norm(c1, axis=1) *
                                 np.linalg.norm(c2, axis=1))
    lines[:, 6] = np.arccos(np.clip(cosang, -1, 1))
    lines[:, 7] = arc_list[:, 9]
    return lines


def combine_edges(per_view_lifted, use_native=True):
    """Conservatively merge near-collinear overlapping segments, 3 rounds.

    Ref: combineEdgesN (pano_lsd_align.py:348-436). Returns (merged,
    originals), both (N, 8). The sequential merge rounds run in C++
    (merge.cpp) — they were the dominant host cost of VP alignment;
    ``use_native=False`` selects the numpy twin below (kept as the
    readable spec and pinned against the C++ path in tests).
    """
    stacks = [p for p in per_view_lifted if len(p)]
    if not stacks:
        return np.zeros((0, 8)), np.zeros((0, 8))
    arc_list = np.vstack(stacks)
    ori_lines = segments_to_lines(arc_list)

    if use_native:
        from .native import merge_rounds
        return merge_rounds(ori_lines, rounds=3), ori_lines
    return _merge_rounds_py(ori_lines), ori_lines


def _merge_rounds_py(ori_lines, events=None):
    """Numpy spec of the merge rounds (see combine_edges).

    ``events``: optional list collecting (round_idx, i, j) per absorption,
    used by tests to pin the C++ engine to the same decision sequence.
    """
    lines = ori_lines.copy()
    cos_exact = np.cos(np.pi / 180)
    for round_idx in range(3):
        n = len(lines)
        valid = np.ones(n, bool)
        # Candidate prefilter: one |N N^T| at round start with a 5-degree
        # margin. Normals only drift by merging >1-degree-parallel lines,
        # so the stale mask is a strict superset of the exact 1-degree
        # test, which is re-evaluated on current normals below. The pair
        # list is materialized once (CSR-style) so the per-line scan
        # touches only its few candidates, not an n-wide mask row — the
        # row scans were ~90% of preprocess's merge cost.
        N0 = lines[:, :3]
        cand_mask = np.abs(N0 @ N0.T) > np.cos(5 * np.pi / 180)
        np.fill_diagonal(cand_mask, False)
        pair_i, pair_j = np.nonzero(cand_mask)
        row_start = np.searchsorted(pair_i, np.arange(n + 1))
        for i in range(n):
            if not valid[i]:
                continue
            cand = pair_j[row_start[i]:row_start[i + 1]]
            if len(cand) == 0:
                continue
            cand = cand[valid[cand]]
            if len(cand) == 0:
                continue
            dots = lines[cand, :3] @ lines[i, :3]
            for j in cand[np.abs(dots) > cos_exact]:
                if not _range_intersects(lines[i, 4:6], lines[j, 4:6]):
                    continue
                if events is not None:
                    events.append((round_idx, i, int(j)))
                # arclength-weighted merged normal (sign-aligned)
                axis = np.argmax(np.abs(lines[i, :3]))
                if lines[i, axis] * lines[j, axis] > 0:
                    nc = lines[i, :3] * lines[i, 6] + lines[j, :3] * lines[j, 6]
                else:
                    nc = lines[i, :3] * lines[i, 6] - lines[j, :3] * lines[j, 6]
                nc /= np.linalg.norm(nc)

                r1, r2 = lines[i, 4:6], lines[j, 4:6]
                nrmin = r2[0] if _inside_range(r1[0], r2) else r1[0]
                nrmax = r2[1] if _inside_range(r1[1], r2) else r1[1]

                u = np.array([[nrmin], [nrmax]]) * 2 * np.pi - np.pi
                v = computeUVN(nc, u, lines[i, 3])
                xyz = uv2xyzN(np.hstack([u, v]), lines[i, 3])
                arclen = np.arccos(np.clip(np.dot(xyz[0], xyz[1]), -1, 1))
                score = (lines[i, 6] * lines[i, 7] + lines[j, 6] * lines[j, 7]) \
                    / (lines[i, 6] + lines[j, 6])
                lines[i] = [*nc, lines[i, 3], nrmin, nrmax, arclen, score]
                valid[j] = False
        lines = lines[valid]
    return lines


_NEAR_SAMPLES = 100


def _segment_endpoints_xyz(lines):
    """Unit xyz of each line's (start, end) uv endpoint. -> ([N,3], [N,3])."""
    u = np.stack([lines[:, 4], lines[:, 5]], -1).reshape(-1, 1) \
        * 2 * np.pi - np.pi
    v = computeUVN_vec(lines[:, :3], u, lines[:, 3])
    xyz = uv2xyzN_vec(np.hstack([u, v]), np.repeat(lines[:, 3], 2))
    return xyz[0::2], xyz[1::2]


def _near_vp_any_sampled(starts, ends, vp, cos_thresh, n_sample):
    """Test oracle: materialize the n_sample chord points, normalize,
    and test |dot| > cos_thresh — the reference's literal formulation
    (pano_lsd_align.py:726-735). Kept only to pin the closed form below."""
    t = np.linspace(0, 1, n_sample)
    samples = starts[:, None, :] * (1 - t[None, :, None]) \
        + ends[:, None, :] * t[None, :, None]
    samples /= np.linalg.norm(samples, axis=-1, keepdims=True)
    return (np.abs(samples @ vp.T) > cos_thresh).any(1)      # [N,V]


def _near_vp_any(starts, ends, vp, cos_thresh, n_sample=_NEAR_SAMPLES):
    """"Any of n_sample chord points within acos(cos_thresh) of a VP",
    without the [N, S, 3] sample tensor.

    The chord point is p(t) = (1-t)a + t b; the test
    |dot(p/|p|, v)| > c  <=>  f(t) = dot(p,v)^2 - c^2 |p|^2 > 0, and f is
    a plain quadratic in t (a, b unit => |p|^2 = 1 - 2(1-m) t(1-t) with
    m = dot(a,b)). Over the reference's uniform t-grid, f's maximum sits
    at t=0, t=1, or (when the quadratic is concave) at one of the two
    grid neighbours of the vertex — so evaluating f at those <=4 grid
    points reproduces the 100-sample test exactly, 100x fewer ops.
    Equality with the sampled oracle is pinned in the tests.
    """
    da = starts @ vp.T                                    # [N,V]
    db = ends @ vp.T
    m = np.sum(starts * ends, 1)                          # [N]
    c2 = cos_thresh * cos_thresh
    w = 2.0 * c2 * (1.0 - m)[:, None]                     # c^2*(|p|^2 quad)
    d = db - da
    A = d * d - w
    B = 2.0 * da * d + w
    C = da * da - c2
    # grid neighbours of the vertex, only meaningful where A < 0 (concave)
    with np.errstate(divide="ignore", invalid="ignore"):
        tv = -B / (2.0 * A)
    k = np.clip(np.floor(np.nan_to_num(tv) * (n_sample - 1)),
                0, n_sample - 2)
    concave = A < 0
    t2 = np.where(concave, k / (n_sample - 1), 0.0)
    t3 = np.where(concave, (k + 1) / (n_sample - 1), 0.0)
    ts = np.stack([np.zeros_like(tv), np.ones_like(tv), t2, t3], -1)
    f = (A[..., None] * ts + B[..., None]) * ts + C[..., None]
    return (f > 0).any(-1)                                    # [N,V]


def assign_vanishing_type(lines, vp, tol, area=10):
    """Assign each line to the nearest VP (or none).

    Cost = angle between line normal and VP (normal perpendicular to VP
    direction means the line points at the VP); lines passing too close to
    the VP itself are disqualified. Ref: pano_lsd_align.py:715-741.
    """
    n_line, n_vp = len(lines), len(vp)
    vp = np.asarray(vp, np.float64)
    cosint = lines[:, :3] @ vp.T if n_line else np.zeros((0, n_vp))
    cost = np.arcsin(np.clip(np.abs(cosint), -1, 1))

    if n_line:
        starts, ends = _segment_endpoints_xyz(lines)
        near = _near_vp_any(starts, ends, vp,
                            np.cos(area * np.pi / 180))
        cost[near] = 100

    best = cost.min(1)
    tp = cost.argmin(1)
    tp[best > tol] = n_vp + 1
    return tp, cost


def _sample_line_arcs(lines, num_sample):
    """Sample num_sample points along every line's arc. -> xyz [N,S,3]."""
    from .sphere import great_circle_xyz_batch

    sid = lines[:, 4] * 2 * np.pi
    eid = lines[:, 5] * 2 * np.pi
    wrap = eid < sid
    end = np.where(wrap, eid + 2 * np.pi, eid)
    t = np.linspace(0, 1, num_sample)
    x = sid[:, None] + (end - sid)[:, None] * t[None, :]
    x = np.where(wrap[:, None], np.mod(x, 2 * np.pi), x)
    u = -np.pi + x
    return great_circle_xyz_batch(lines[:, :3], u, lines[:, 3])


def refit_line_segments(lines, vp, vpweight=0.1):
    """Refit each line's great circle, optionally pulled toward the VP.

    Vectorized over all lines: per-line scatter matrices built by one
    einsum, batched 3x3 SVD. Ref behavior: pano_lsd_align.py:744-774.
    """
    num_sample = 100
    if len(lines) == 0:
        return lines.copy()
    out = lines.copy()
    xyz = _sample_line_arcs(lines, num_sample)          # [N,S,3]
    xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    vp = np.asarray(vp, np.float64).reshape(3)
    vp_unit = vp / np.linalg.norm(vp)
    # weights: 1 per sample + vpweight*num_sample on the vp point
    # batched [3,S]@[S,3] (BLAS) — same contraction as
    # einsum("nsi,nsj->nij") but einsum doesn't dispatch to BLAS here
    A = np.matmul(xyz.transpose(0, 2, 1), xyz)
    wvp = (vpweight * num_sample) ** 2
    A = A + wvp * np.outer(vp_unit, vp_unit)[None]
    _, _, Vh = np.linalg.svd(A)
    nm = Vh[:, -1, :]
    out[:, :3] = nm / np.linalg.norm(nm, axis=1, keepdims=True)
    return out


def paint_parameter_lines(lines, width, height):
    """Raster the great-circle arcs onto a pano-sized map (vectorized).

    Ref: pano_lsd_align.py:777-801 (pixel value = line index, as there).
    The raster is an output/debug artifact (nothing downstream reads the
    values, only nonzero-ness), so the arc sampling runs in float32 —
    half the memory traffic of the f64 geometry path for a map whose
    precision floor is the pixel grid anyway.
    """
    canvas = np.zeros((height, width))
    if len(lines) == 0:
        return canvas
    num_sample = max(height, width)
    lines32 = np.asarray(lines, np.float32)
    pid = lines[:, 3].astype(int)
    sid = lines32[:, 4] * (2 * np.float32(np.pi))
    eid = lines32[:, 5] * (2 * np.float32(np.pi))
    wrap = eid < sid
    end = np.where(wrap, eid + 2 * np.float32(np.pi), eid)
    t = np.linspace(0, 1, num_sample, dtype=np.float32)
    x = sid[:, None] + (end - sid)[:, None] * t[None, :]
    x = np.where(wrap[:, None], np.mod(x, 2 * np.float32(np.pi)), x)
    u = x - np.float32(np.pi)                            # [N,S]
    # v of each great circle at u (computeUVN with per-row planeID roll)
    n = lines32[:, :3].copy()
    m2, m3 = pid == 2, pid == 3
    if m2.any():
        n[m2] = np.roll(n[m2], 2, axis=1)
    if m3.any():
        n[m3] = np.roll(n[m3], 1, axis=1)
    su, cu = np.sin(u), np.cos(u)
    bc = n[:, [0]] * su + n[:, [1]] * cu
    # v = arctan(w): cos v = 1/sqrt(1+w^2) > 0, sin v = w*cos v — same
    # fusion as sphere.great_circle_xyz_batch, in f32
    w = -bc / (n[:, [2]] + np.float32(1e-9))
    cv = np.float32(1.0) / np.sqrt(np.float32(1.0) + w * w)
    sv = w * cv
    # uv -> xyz in each row's plane convention, then to planeID=1 uv
    comp = np.stack([cv * su, cv * cu, sv], axis=-1)     # [N,S,3] local
    xyz = np.empty_like(comp)
    ids = (np.arange(3)[None, :] + (pid - 1)[:, None]) % 3
    for k in range(3):
        xyz[np.arange(len(lines)), :, ids[:, k]] = comp[:, :, k]
    x1, x2, x3 = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    norm_xy = np.maximum(np.sqrt(x1 ** 2 + x2 ** 2), np.float32(1e-6))
    norm = np.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2)
    vv = np.arcsin(np.clip(x3 / norm, -1, 1))
    uu = np.arcsin(np.clip(x1 / norm_xy, -1, 1))
    uu = np.where((x2 < 0) & (uu >= 0), np.float32(np.pi) - uu, uu)
    uu = np.where((x2 < 0) & (uu < 0), -np.float32(np.pi) - uu, uu)
    cols = np.minimum(np.floor((uu + np.pi) / (2 * np.pi) * width) + 1,
                      width).astype(np.int32)
    rows = np.minimum(np.floor((np.pi / 2 - vv) / np.pi * height) + 1,
                      height).astype(np.int32)
    idx = np.broadcast_to(np.arange(len(lines))[:, None], rows.shape)
    canvas[rows.ravel() - 1, cols.ravel() - 1] = idx.ravel()
    return canvas
