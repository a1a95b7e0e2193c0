"""Host tails of cuboid and general-layout serving (numpy).

Counterpart of horizonnet_tpu/postproc/serving.py. The cuboid tail only
unpacks the packed [B, 17] fit. The general tail turns each pano's device
candidate summary (postproc/device.py::postprocess_general_batch: peak
columns, per-(segment, axis) vote fits, scores, L1s and means, z1 and a
cuboid fallback) into its corner list: Wall candidates with the host
voter's axis pick, the greedy commitment ring, the plan validity check,
and the cuboid fallback on failure (ref inference.py:104-141). This is
O(#walls <= 32) scalar work per pano, the sequential part the reference
also runs on the host.
"""

import sys

import numpy as np
import torch

from ..geometry.equirect_host import coorx2u, infer_coory, xy2coor
from ..geometry.polygon import polygon_is_valid, polygon_is_valid_batch
from ..utils import profiling
from .manhattan import Wall, _GreedyRing


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def unpack_cuboid_outputs(packed):
    """Host twin of device.pack_cuboid_outputs: ONE [B, 17] float32 array
    (numpy or a tensor on any device) -> (cor_id [B, 8, 2], z1 [B]).
    Also accepts the raw (cor_id, z1) pair."""
    if isinstance(packed, (tuple, list)):
        cor_id, z1 = packed
        return _host(cor_id), _host(z1)
    packed = _host(packed).astype(np.float32)
    return packed[:, :16].reshape(-1, 8, 2), packed[:, 16]


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
    the rest take the scalar greedy. Traced as the span ``tail.general``
    (utils/profiling.py).
    """
    with profiling.span("tail.general"):
        return _finish_general_batch(outputs, coorW, coorH, z0)


def _finish_general_batch(outputs, coorW, coorH, z0):
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
