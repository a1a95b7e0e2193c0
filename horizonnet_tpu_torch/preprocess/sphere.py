"""Spherical coordinate conventions and icosahedral sampling.

Copied from horizonnet_tpu/preprocess/sphere.py (numpy; no torch).

The VP pipeline works with great-circle normals in a 3-axis-permutable
spherical convention indexed by ``planeID`` in {1,2,3} (inherited from the
LayoutNet Matlab code; reference misc/pano_lsd_align.py:19-98). For
planeID p the coordinate axes are cyclically rotated by p-1, u is the
azimuth measured from axis ID2 toward axis ID1, v the elevation toward
axis ID3.
"""

import numpy as np


def xyz2uvN(xyz, planeID=1):
    """Unit vectors -> (u, v) in the planeID convention. xyz: (N, 3).

    Ref behavior: misc/pano_lsd_align.py:53-68.
    """
    xyz = np.asarray(xyz, np.float64)
    ID1 = (int(planeID) - 1 + 0) % 3
    ID2 = (int(planeID) - 1 + 1) % 3
    ID3 = (int(planeID) - 1 + 2) % 3
    x1, x2, x3 = xyz[:, ID1], xyz[:, ID2], xyz[:, ID3]
    normXY = np.maximum(np.sqrt(x1 ** 2 + x2 ** 2), 1e-6)
    normXYZ = np.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2)
    v = np.arcsin(x3 / normXYZ)
    u = np.arcsin(np.clip(x1 / normXY, -1, 1))
    # unfold the arcsin to the full (-pi, pi] azimuth using the x2 sign
    u = np.where((x2 < 0) & (u >= 0), np.pi - u, u)
    u = np.where((x2 < 0) & (u < 0), -np.pi - u, u)
    u = np.where(np.isnan(u), 0.0, u)
    return np.stack([u, v], axis=-1)


def uv2xyzN(uv, planeID=1):
    """(u, v) -> unit vectors in the planeID convention. uv: (N, 2).

    Ref behavior: misc/pano_lsd_align.py:71-79.
    """
    uv = np.asarray(uv, np.float64)
    ID1 = (int(planeID) - 1 + 0) % 3
    ID2 = (int(planeID) - 1 + 1) % 3
    ID3 = (int(planeID) - 1 + 2) % 3
    xyz = np.zeros((len(uv), 3))
    xyz[:, ID1] = np.cos(uv[:, 1]) * np.sin(uv[:, 0])
    xyz[:, ID2] = np.cos(uv[:, 1]) * np.cos(uv[:, 0])
    xyz[:, ID3] = np.sin(uv[:, 1])
    return xyz


def xyz2uvN_vec(xyz, planeID):
    """Per-row planeID variant. xyz: (N,3); planeID: (N,)."""
    out = np.zeros((len(xyz), 2))
    for p in (1, 2, 3):
        m = planeID == p
        if m.any():
            out[m] = xyz2uvN(xyz[m], p)
    return out


def uv2xyzN_vec(uv, planeID):
    """Per-row planeID variant (ref pano_lsd_align.py:82-98)."""
    out = np.zeros((len(uv), 3))
    planeID = np.asarray(planeID).astype(int)
    for p in (1, 2, 3):
        m = planeID == p
        if m.any():
            out[m] = uv2xyzN(uv[m], p)
    return out


def computeUVN(n, u, planeID):
    """v of the great circle with normal n at azimuth(s) u.

    Ref behavior: misc/pano_lsd_align.py:19-30.
    """
    n = np.asarray(n, np.float64).reshape(3)
    if planeID == 2:
        n = np.array([n[1], n[2], n[0]])
    elif planeID == 3:
        n = np.array([n[2], n[0], n[1]])
    bc = n[0] * np.sin(u) + n[1] * np.cos(u)
    return np.arctan(-bc / (n[2] + 1e-9))


def computeUVN_vec(n, u, planeID):
    """Vectorized: n (N,3), u (M,1) with M = k*N, planeID (N,).

    Ref behavior: misc/pano_lsd_align.py:33-50.
    """
    n = np.asarray(n, np.float64).copy()
    planeID = np.asarray(planeID)
    if (planeID == 2).sum():
        n[planeID == 2] = np.roll(n[planeID == 2], 2, axis=1)
    if (planeID == 3).sum():
        n[planeID == 3] = np.roll(n[planeID == 3], 1, axis=1)
    n = np.repeat(n, u.shape[0] // n.shape[0], axis=0)
    bc = n[:, [0]] * np.sin(u) + n[:, [1]] * np.cos(u)
    return np.arctan(-bc / (n[:, [2]] + 1e-9))


import functools


def computeUVN_batch(n, u, planeID):
    """Batched great-circle v: n (N,3), u (N,S), planeID (N,) -> v (N,S)."""
    n = np.asarray(n, np.float64).copy()
    planeID = np.asarray(planeID).astype(int)
    m2 = planeID == 2
    m3 = planeID == 3
    if m2.any():
        n[m2] = np.roll(n[m2], 2, axis=1)
    if m3.any():
        n[m3] = np.roll(n[m3], 1, axis=1)
    bc = n[:, [0]] * np.sin(u) + n[:, [1]] * np.cos(u)
    return np.arctan(-bc / (n[:, [2]] + 1e-9))


def great_circle_xyz_batch(n, u, planeID):
    """xyz on the great circle with normal n at azimuths u, fused.

    Equivalent to ``uv2xyzN_batch(u, computeUVN_batch(n, u, planeID),
    planeID)`` with the arctan -> sin/cos detour collapsed algebraically
    (v = arctan(w) implies cos v = 1/sqrt(1+w^2), sin v = w*cos v, and
    arctan's range keeps cos v > 0) — three transcendental passes become
    one sqrt. This sampling is the hot inner step of refit and paint.
    n: (N,3), u: (N,S), planeID: (N,) -> xyz (N,S,3) unit.
    """
    n = np.asarray(n, np.float64).copy()
    planeID = np.asarray(planeID).astype(int)
    m2 = planeID == 2
    m3 = planeID == 3
    if m2.any():
        n[m2] = np.roll(n[m2], 2, axis=1)
    if m3.any():
        n[m3] = np.roll(n[m3], 1, axis=1)
    su, cu = np.sin(u), np.cos(u)
    bc = n[:, [0]] * su + n[:, [1]] * cu
    w = -bc / (n[:, [2]] + 1e-9)
    cv = 1.0 / np.sqrt(1.0 + w * w)
    sv = w * cv
    comp = np.stack([cv * su, cv * cu, sv], axis=-1)   # local axis order
    N = len(n)
    xyz = np.empty_like(comp)
    ids = (np.arange(3)[None, :] + (planeID - 1)[:, None]) % 3
    for k in range(3):
        xyz[np.arange(N), :, ids[:, k]] = comp[:, :, k]
    return xyz


def uv2xyzN_batch(u, v, planeID):
    """Batched uv->xyz: u, v (N,S), planeID (N,) -> xyz (N,S,3)."""
    planeID = np.asarray(planeID).astype(int)
    N, S = u.shape
    xyz = np.zeros((N, S, 3))
    comp = np.stack([np.cos(v) * np.sin(u), np.cos(v) * np.cos(u),
                     np.sin(v)], axis=-1)  # [N,S,3] in local axis order
    ids = (np.arange(3)[None, :] + (planeID - 1)[:, None]) % 3  # [N,3]
    for k in range(3):
        xyz[np.arange(N), :, ids[:, k]] = comp[:, :, k]
    return xyz


@functools.lru_cache(maxsize=None)
def icosahedron2sphere(level):
    """Near-uniform sphere sampling by icosahedron subdivision (cached).

    Returns (points (N,3) unit, triangles (M,3) indices).
    Ref behavior: misc/pano_lsd_align.py:439-492.
    """
    phi = (1 + np.sqrt(5)) / 2
    a = 1.0 / phi
    # 12 icosahedron vertices: cyclic permutations of (0, ±a, ±1)
    verts = []
    for i, j in [(a, 1), (a, -1), (-a, 1), (-a, -1)]:
        verts.append([0, i, j])
        verts.append([i, j, 0])
        verts.append([j, 0, i])
    coor = np.array(verts, np.float64)
    coor /= np.linalg.norm(coor, axis=1, keepdims=True)

    # Faces: all triples of mutually-nearest vertices (edge length 2a/|v|)
    d2 = ((coor[:, None] - coor[None, :]) ** 2).sum(-1)
    edge = d2 < (d2[d2 > 1e-9].min() + 1e-6)
    np.fill_diagonal(edge, False)
    tris = set()
    for i in range(12):
        for j in range(i + 1, 12):
            if not edge[i, j]:
                continue
            for k in range(j + 1, 12):
                if edge[i, k] and edge[j, k]:
                    tris.add((i, j, k))
    tri = np.array(sorted(tris))
    assert len(tri) == 20

    coor = list(coor)
    for _ in range(level):
        new_tri = []
        for t in tri:
            n = len(coor)
            coor.append((np.asarray(coor[t[0]]) + coor[t[1]]) / 2)
            coor.append((np.asarray(coor[t[1]]) + coor[t[2]]) / 2)
            coor.append((np.asarray(coor[t[2]]) + coor[t[0]]) / 2)
            new_tri += [[n, t[0], n + 2], [n, t[1], n + 1],
                        [n + 1, t[2], n + 2], [n, n + 1, n + 2]]
        tri = np.array(new_tri)
        arr = np.array(coor)
        arr, idx = np.unique(arr, return_inverse=True, axis=0)
        tri = idx[tri]
        arr = arr / np.linalg.norm(arr, axis=1, keepdims=True)
        coor = list(arr)
    return np.array(coor), np.asarray(tri)


def fit_plane_normal(xyz, weight):
    """Weighted best-fit plane normal through the origin (smallest
    eigenvector of the weighted scatter). Ref: pano_lsd_align.py:495-518.
    """
    xyz = np.asarray(xyz, np.float64)
    w = np.asarray(weight, np.float64).reshape(-1, 1)
    xyz = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
    wxyz = xyz * w
    A = wxyz.T @ wxyz
    _, _, Vh = np.linalg.svd(A)
    nm = Vh[-1]
    return nm / np.linalg.norm(nm)
