"""Vanishing-point estimation: vectorized icosahedral sphere Hough.

Copied from horizonnet_tpu/preprocess/vanishing.py (numpy; no torch).

Reference behavior: misc/pano_lsd_align.py:521-705 (sphereHoughVote,
findMainDirectionEMA). The reference's triple-nested loop over bin triples
is the preprocessing hot spot (SURVEY.md §3.1); here the two inner loops
collapse into masked matrix products per outer bin — identical
candidate-selection semantics (same iteration order, strict-> updates),
two orders of magnitude fewer Python iterations.

Divergence note: the reference also returns the cost/angle delta of the
LAST accepted candidate (diagnostics only, unused by the pipeline); the
vectorized search reports the delta of the best candidate per outer bin.
"""

import sys

import numpy as np

from .sphere import xyz2uvN, icosahedron2sphere, fit_plane_normal


def _accept(state, new_best, total, bins):
    """One strict-> update of the running best triple."""
    best, vote_max, last_cost, last_angle = state
    last_cost = total - vote_max
    if vote_max != 0:
        tmp = (bins[list(best)] * bins[list(new_best)]).sum(1)
        last_angle = np.arccos(tmp.clip(-1, 1))
    else:
        last_angle = np.zeros(3)
    return new_best, total, last_cost, last_angle


def _search_triples(bins, votes, check1, nonzero, orth_cos, third_cos,
                    force_unempty, use_native=True):
    """Orthogonal-triple search in the reference's scan order
    (sphereHoughVote, pano_lsd_align.py:556-607).

    The default engine is C++ (vote.cpp, ~10x: the numpy form below is
    ~180 outer-bin iterations of small-array overhead on a few Mflop of
    real work); ``use_native=False`` selects the numpy twin, kept as the
    readable spec and pinned against the C++ path in tests.
    """
    if use_native:
        from .native import search_triples
        return search_triples(bins, votes, check1, nonzero, orth_cos,
                              third_cos, force_unempty)
    return _search_triples_py(bins, votes, check1, nonzero, orth_cos,
                              third_cos, force_unempty)


def _search_triples_py(bins, votes, check1, nonzero, orth_cos, third_cos,
                       force_unempty):
    """Numpy spec of the triple search: one Python iteration per first
    direction, with the two inner loops collapsed into one [N, K]
    masked product per outer bin.

    Measured note: a further chunk-vectorization over the outer bins
    (one [N, P] product for many b1 at once + sequential acceptance
    replay) was built and benchmarked SLOWER on real panos (60-105 vs
    44-56 ms per find_main_direction call) — per-b1 [N, K] blocks stay
    cache-resident while pair-chunk blocks don't, and BLAS gains nothing
    past these sizes — so this per-b1 form was the implementation until
    the C++ engine (vote.cpp) replaced both.
    """
    gram = bins @ bins.T
    state = ((0, 0, 0), 0.0, 0, 0)
    for b1 in check1:
        if force_unempty and not nonzero[b1]:
            continue
        v1 = votes[b1]
        cand2 = np.nonzero(np.abs(gram[b1]) < orth_cos)[0]
        if force_unempty:
            cand2 = cand2[nonzero[cand2]]
        if len(cand2) == 0:
            continue
        # Third-direction alignment for every (b2 in cand2, bin)
        cross = np.cross(bins[b1][None, :], bins[cand2])      # [K, 3]
        cn = np.linalg.norm(cross, axis=1, keepdims=True)
        D = np.abs(bins @ cross.T) / cn.T                      # [N, K]
        valid3 = (D > third_cos) & nonzero[:, None]            # [N, K]
        v3 = np.where(valid3, votes[:, None], -np.inf)
        best3_idx = v3.argmax(0)                               # per b2
        best3_val = v3[best3_idx, np.arange(len(cand2))]
        total = v1 + votes[cand2] + best3_val
        total[~np.isfinite(total)] = -np.inf
        i_best = int(total.argmax())
        if total[i_best] > state[1]:
            new_best = (int(b1), int(cand2[i_best]),
                        int(best3_idx[i_best]))
            state = _accept(state, new_best, total[i_best], bins)
    return state


def sphere_hough_vote(seg_normal, seg_length, seg_scores, bin_radius,
                      orth_tolerance, candi_set, force_unempty=True):
    """Find 3 orthogonal directions maximizing accumulated segment votes.

    Returns (3x3 refined orthogonal directions or None, last_cost,
    last_angle).
    """
    seg_normal = np.asarray(seg_normal, np.float64).copy()
    seg_length = np.asarray(seg_length, np.float64).reshape(-1)
    seg_scores = np.asarray(seg_scores, np.float64).reshape(-1)

    bins = candi_set[~(candi_set[:, 2] < 0)]
    flip = seg_normal[:, 2] < 0
    seg_normal[flip] = -seg_normal[flip]

    bin_uv = xyz2uvN(bins)
    # Vote accumulation: one [numBins, numSegs] mask matmul
    dots = bins @ seg_normal.T
    near_gc = np.abs(dots) < np.cos((90 - bin_radius) * np.pi / 180)
    votes = near_gc @ (seg_scores * seg_length)

    orth_cos = np.cos((90 - orth_tolerance) * np.pi / 180)
    third_cos = np.cos(orth_tolerance * np.pi / 180)
    nonzero = votes > 0 if force_unempty else np.ones(len(bins), bool)

    check1 = np.nonzero(bin_uv[:, 1] > np.pi / 3)[0]
    best, vote_max, last_cost, last_angle = _search_triples(
        bins, votes, check1, nonzero, orth_cos, third_cos, force_unempty)

    if best[0] == 0:
        print("[WARN] sphere_hough_vote: no orthogonal voting exist",
              file=sys.stderr)
        return None, 0, 0
    init_xyz = bins[list(best)]

    # SVD refinement of each direction from its supporting segments
    refi = np.zeros((3, 3))
    thresh = np.cos((90 - bin_radius) * np.pi / 180)

    sel = np.abs((seg_normal * init_xyz[0]).sum(1)) < thresh
    wt = (seg_length[sel] * seg_scores[sel]).reshape(-1, 1)
    wt = wt / wt.max()
    refi[0] = fit_plane_normal(seg_normal[sel], wt)

    sel = np.abs((seg_normal * init_xyz[1]).sum(1)) < thresh
    wt = (seg_length[sel] * seg_scores[sel]).reshape(-1, 1)
    wt = wt / wt.max()
    nm = np.vstack([seg_normal[sel], refi[[0]]])
    wt = np.vstack([wt, wt.sum(0, keepdims=True) * 0.1])
    refi[1] = fit_plane_normal(nm, wt)

    third = np.cross(refi[0], refi[1])
    refi[2] = third / np.linalg.norm(third)
    return refi, last_cost, last_angle


def find_main_direction(lines):
    """Iteratively estimate the 3 (+3 mirrored) main directions.

    Ref: findMainDirectionEMA (pano_lsd_align.py:617-705).
    """
    seg_normal = lines[:, :3]
    seg_length = lines[:, [6]]
    seg_scores = np.ones((len(lines), 1))

    short = (seg_length < 5 * np.pi / 180).reshape(-1)
    seg_normal = seg_normal[~short]
    seg_length = seg_length[~short]
    seg_scores = seg_scores[~short]

    candi, tri = icosahedron2sphere(3)
    ang = np.arccos(np.clip((candi[tri[0, 0]] * candi[tri[0, 1]]).sum(),
                            -1, 1)) / np.pi * 180
    bin_radius = ang / 2
    cur, score, angle = sphere_hough_vote(
        seg_normal, seg_length, seg_scores, 2 * bin_radius, 2, candi)
    if cur is None:
        print("[WARN] find_main_direction: initial failed", file=sys.stderr)
        return None, score, angle

    iter_max = 3
    candi_d, tri_d = icosahedron2sphere(5)
    ang_d = np.arccos(np.clip((candi_d[tri_d[0, 0]] * candi_d[tri_d[0, 1]])
                              .sum(), -1, 1)) / np.pi * 180
    bin_radius_d = ang_d / 2
    tol = np.linspace(4 * bin_radius, 4 * bin_radius_d, iter_max)
    for it in range(iter_max):
        c = np.cos((90 - tol[it]) * np.pi / 180)
        sel = (np.abs(seg_normal @ cur[0]) < c) | \
              (np.abs(seg_normal @ cur[1]) < c) | \
              (np.abs(seg_normal @ cur[2]) < c)
        if sel.sum() == 0:
            print("[WARN] find_main_direction: zero segments for voting",
                  file=sys.stderr)
            break
        cc = np.cos(tol[it] * np.pi / 180)
        bsel = (np.abs(candi_d @ cur[0]) > cc) | \
               (np.abs(candi_d @ cur[1]) > cc) | \
               (np.abs(candi_d @ cur[2]) > cc)
        if bsel.sum() == 0:
            print("[WARN] find_main_direction: zero bins for voting",
                  file=sys.stderr)
            break
        new, _, _ = sphere_hough_vote(
            seg_normal[sel], seg_length[sel], seg_scores[sel],
            2 * bin_radius_d, 2, candi_d[bsel])
        if new is None:
            print("[WARN] find_main_direction: no answer found",
                  file=sys.stderr)
            break
        cur = new.copy()

    main = cur.copy()
    main *= np.sign(main[:, [2]])
    # Canonical ordering: most-vertical first, then most-aligned with y
    uv = xyz2uvN(main)
    i1 = int(np.argmax(uv[:, 1]))
    rest = np.setdiff1d(np.arange(3), i1)
    i2 = rest[int(np.argmin(np.abs(np.sin(uv[rest, 0]))))]
    i3 = int(np.setdiff1d(np.arange(3), [i1, i2])[0])
    main = np.vstack([main[i1], main[i2], main[i3]])
    main[0] *= np.sign(main[0, 2])
    main[1] *= np.sign(main[1, 1])
    main[2] *= np.sign(main[2, 0])
    return np.vstack([main, -main]), score, angle
