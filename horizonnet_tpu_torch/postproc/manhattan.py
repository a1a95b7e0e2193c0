"""Manhattan-world wall fitting from the 1D ceiling boundary (host numpy).

Copy of horizonnet_tpu/postproc/manhattan.py, whose behavioural contract
is the reference's misc/post_proc.py (cited per function): project the
per-column ceiling boundary onto the floor plane, split the columns into
wall segments at the corner columns, vote an axis-aligned line per
segment, then commit walls greedily (highest score first) while forcing
the x/y wall types to alternate. ``gen_ww`` is the host postprocess's fit
(inference.py::postprocess); ``Wall`` and ``_GreedyRing`` also serve the
general-layout serving tail (postproc/serving.py). The JAX package's
``postproc/__init__.py`` imports its device module, which imports jax, so
the port keeps its own copy, in float64 on the host as there.
"""

import dataclasses

import numpy as np

from ..geometry.equirect_host import (coor2xy, coorx2u, x_u_solve_y,
                                      xy2coor, y_u_solve_x)


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


def fuv2img(fuv, coorW=1024, floorW=1024, floorH=512):
    """Project a per-column 1D signal onto the top-down floor plane: each
    floor-plane pixel samples the signal at the column of its azimuth
    (linear, periodic). Ref: misc/post_proc.py:10-19."""
    fuv = np.asarray(fuv, np.float64)
    ys, xs = np.meshgrid(np.arange(floorH), np.arange(floorW), indexing="ij")
    px = -(ys - floorH / 2)
    py = xs - floorW / 2
    coridx = (np.arctan2(py, px) / (2 * np.pi) + 0.5) * coorW - 0.5
    lo = np.floor(coridx).astype(int) % coorW
    hi = (lo + 1) % coorW
    w = coridx - np.floor(coridx)
    return fuv[lo] * (1 - w) + fuv[hi] * w


def gpid_two_split(xy, tpid_a, tpid_b):
    """Best split of a segment into two walls of types a then b: the
    split point maximizing a cumulative-mean separation score; returns
    the mean coordinate of each side. Ref: misc/post_proc.py:150-164."""
    m = np.arange(len(xy)) + 1
    cum_a = np.cumsum(xy[:, tpid_a])
    cum_b = np.cumsum(xy[::-1, tpid_b])
    l1_a = cum_a / m - cum_a / (m * m)
    l1_b = (cum_b / m - cum_b / (m * m))[::-1]
    score = l1_a[:-1] + l1_b[1:]
    best_split = score.argmax() + 1
    va = xy[:best_split, tpid_a].mean()
    vb = xy[best_split:, tpid_b].mean()
    return va, vb


def _principal_rot_deg(px, py):
    """Rotation (deg) folding a principal direction into +-45 of an axis."""
    if px < 0:
        px, py = -px, -py
    rad = np.arctan2(py, px) * 180 / np.pi
    if rad > 45:
        return 90 - rad
    if rad < -45:
        return -90 - rad
    return -rad


def get_rot_rad(init_coorx, coory, z=50, coorW=1024, coorH=512,
                floorW=1024, floorH=512, tol=5):
    """Suggest a global pano rotation aligning walls with the plan axes.

    Per wall segment the dominant plan direction is the 2x2 covariance's
    principal eigenvector (closed form, where the reference calls
    sklearn's PCA, misc/post_proc.py:178-202); suggestions cluster within
    ``tol`` degrees and the densest cluster wins. Returns (column shift
    dx, rotation degrees)."""
    gpid = get_gpid(init_coorx, coorW)
    coor = np.stack([np.arange(coorW), np.asarray(coory)], axis=-1)
    xy = coor2xy(coor, z, coorW, coorH, floorW, floorH)

    suggestions = []
    for j in range(len(init_coorx)):
        pts = xy[gpid == j]
        c = pts - pts.mean(0)
        cov = c.T @ c
        w, v = np.linalg.eigh(cov)
        principal = v[:, np.argmax(w)]
        suggestions.append(_principal_rot_deg(*principal))
    suggestions = np.sort(suggestions + [1e9])

    rot = np.mean(suggestions[:-1])
    best_sz = -1
    last_j = 0
    for j in range(1, len(suggestions)):
        if suggestions[j] - suggestions[j - 1] > tol:
            last_j = j
        elif j - last_j > best_sz:
            rot = suggestions[last_j:j + 1].mean()
            best_sz = j - last_j
    dx = int(round(rot * 1024 / 360))
    return dx, rot


def get_gpid(coorx, coorW):
    """Wall-segment id per column, split at the corner columns; segment 0
    wraps across the seam. Ref: misc/post_proc.py:134-139."""
    gpid = np.zeros(coorW)
    gpid[np.round(coorx).astype(int)] = 1
    gpid = np.cumsum(gpid).astype(int)
    gpid[gpid == gpid[-1]] = 0
    return gpid


def vote(vec, tol):
    """Consensus vote for a dominant coordinate among a segment's samples.

    Finds the largest sorted index span [i, j] whose extreme values lie
    within ``tol`` and which covers >= 40% of the samples; returns the
    span mean, the covered fraction as score, and the L1 residual. Falls
    back to the median with score 0. The flat argmax's tie order (lowest
    row, then lowest column) and the ``m < tol`` test are the JAX
    package's. Ref: misc/post_proc.py:75-98.
    """
    vec = np.sort(np.asarray(vec, np.float64))
    m = len(vec)
    j_idx = np.arange(m)
    span = j_idx[None, :] - j_idx[:, None] + 1            # n(i,j) = j - i + 1
    dist = np.abs(vec[None, :] - vec[:, None])
    dist = dist + np.where(np.eye(m, dtype=bool), 0.0, 1e-9)

    invalid = (span < m * 0.4) | (dist > tol)
    if (~invalid).sum() == 0 or m < tol:
        best_fit = np.median(vec)
        p_score = 0
    else:
        score = np.where(invalid, -1, span)
        flat = int(score.argmax())
        row, col = flat // m, flat % m
        assert col > row
        best_fit = vec[row:col + 1].mean()
        p_score = (col - row + 1) / m

    l1_score = np.abs(vec - best_fit).mean()
    return best_fit, p_score, l1_score


def _segment_candidate(xy, gpid, j, tol):
    """Vote both axes for segment j; pick the better-scoring wall axis."""
    now_x = xy[gpid == j, 0]
    now_y = xy[gpid == j, 1]
    new_x, x_score, x_l1 = vote(now_x, tol)
    new_y, y_score, y_l1 = vote(now_y, tol)
    if (x_score, -x_l1) > (y_score, -y_l1):
        return Wall(axis=0, value=new_x, score=x_score, seg=j)
    return Wall(axis=1, value=new_y, score=y_score, seg=j)


def gen_ww_cuboid(xy, gpid, tol):
    """4-wall fit; when the voted axes do not alternate, the alternation
    parity whose walls carry the higher total score wins.
    Ref: misc/post_proc.py:205-238."""
    assert len(np.unique(gpid)) == 4
    walls = [_segment_candidate(xy, gpid, j, tol) for j in range(4)]

    scores = [0.0, 0.0]
    for j, w in enumerate(walls):
        scores[j % 2] += w.score if w.axis == 0 else -w.score
    first = 0 if scores[0] > scores[1] else 1
    for j, w in enumerate(walls):
        w.axis = (first + j) % 2
    return walls


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


def gen_ww_general(init_coorx, xy, gpid, tol):
    """Greedy highest-score-first wall commitment with forced alternation
    (the rules live in _GreedyRing). Ref: misc/post_proc.py:241-334."""
    n_seg = len(init_coorx)
    assert n_seg == len(np.unique(gpid))

    walls = []
    for j in range(n_seg):
        w = _segment_candidate(xy, gpid, j, tol)
        w.u0 = coorx2u(init_coorx[(j - 1 + n_seg) % n_seg])
        w.u1 = coorx2u(init_coorx[j])
        w.pending = True
        walls.append(w)
    return _GreedyRing(
        walls, lambda seg, axis: xy[gpid == seg, axis].mean()).run()


def gen_ww(init_coorx, coory, z=50, coorW=1024, coorH=512, floorW=1024,
           floorH=512, tol=3, force_cuboid=True):
    """Full wall fit: project, vote, commit, convert back to pano corners.
    Returns (cor [(N, 2) pixel coords, min-x corner first], walls).
    Ref: misc/post_proc.py:337-359."""
    gpid = get_gpid(init_coorx, coorW)
    coor = np.stack([np.arange(coorW), np.asarray(coory)], axis=-1)
    xy = coor2xy(coor, z, coorW, coorH, floorW, floorH)

    if force_cuboid:
        walls = gen_ww_cuboid(xy, gpid, tol)
    else:
        walls = gen_ww_general(init_coorx, xy, gpid, tol)

    # wall-line intersections -> plan corners -> pano coordinates
    cor = []
    for j in range(len(walls)):
        nxt = (j + 1) % len(walls)
        if walls[j].axis == 1:
            cor.append((walls[nxt].value, walls[j].value))
        else:
            cor.append((walls[j].value, walls[nxt].value))
    cor = xy2coor(np.array(cor), z, coorW, coorH, floorW, floorH)
    cor = np.roll(cor, -2 * cor[::2, 0].argmin(), axis=0)
    return cor, walls
