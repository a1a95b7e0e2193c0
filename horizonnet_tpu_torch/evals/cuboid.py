"""Cuboid metrics: Corner Error, Pixel Error, halfspace-intersection 3D IoU.

Copy of horizonnet_tpu/evals/cuboid.py (host numpy, every dtype and cast
kept). Reference behavior: eval_cuboid.py:49-159. 3D IoU builds 6
halfspaces per corner from floor/ceiling rings and intersects them (Qhull
in the reference; the convex clipper of geometry/polytope.py here,
validated against Qhull in tests).
"""

import glob
import os

import numpy as np

from ..geometry.equirect_host import coor2xy, coory2v_up, infer_coory
from ..geometry.lines import pano_connect_points
from ..geometry.polytope import layout_halfspaces, halfspace_intersection_volume


def eval_3diou(dt_floor_coor, dt_ceil_coor, gt_floor_coor, gt_ceil_coor,
               ch=-1.6, coorW=1024, coorH=512):
    """3D IoU via halfspace-intersection volumes (eval_cuboid.py:49-92)."""
    dt_floor_coor = np.asarray(dt_floor_coor)
    dt_ceil_coor = np.asarray(dt_ceil_coor)
    gt_floor_coor = np.asarray(gt_floor_coor)
    gt_ceil_coor = np.asarray(gt_ceil_coor)
    assert (dt_floor_coor[:, 0] != dt_ceil_coor[:, 0]).sum() == 0
    assert (gt_floor_coor[:, 0] != gt_ceil_coor[:, 0]).sum() == 0

    def rings(floor_coor, ceil_coor):
        N = len(floor_coor)
        floor_xy = coor2xy(floor_coor, ch, coorW, coorH, floorW=1, floorH=1)
        floor_xyz = np.hstack([floor_xy, np.full((N, 1), ch)])
        c = np.sqrt((floor_xy ** 2).sum(1))
        v2 = coory2v_up(ceil_coor[:, 1], coorH)
        ceil_z = c * np.tan(v2)
        ceil_xyz = floor_xyz.copy()
        ceil_xyz[:, 2] = ceil_z
        return floor_xyz, ceil_xyz

    dt_floor_xyz, dt_ceil_xyz = rings(dt_floor_coor, dt_ceil_coor)
    gt_floor_xyz, gt_ceil_xyz = rings(gt_floor_coor, gt_ceil_coor)

    dt_hs = layout_halfspaces(dt_floor_xyz, dt_ceil_xyz)
    gt_hs = layout_halfspaces(gt_floor_xyz, gt_ceil_xyz)

    in_volume = halfspace_intersection_volume(np.concatenate([dt_hs, gt_hs]))
    dt_volume = halfspace_intersection_volume(dt_hs)
    gt_volume = halfspace_intersection_volume(gt_hs)
    un_volume = dt_volume + gt_volume - in_volume
    return 100 * in_volume / un_volume


def _boundary_from_corners(cor_id, offset, z, w):
    """Per-column boundary row traced through the 4 walls.

    cor_id: full interleaved (8, 2) list; offset 0 = ceiling ring,
    1 = floor ring (eval_cuboid.py:109-127).
    """
    xys = np.concatenate([
        pano_connect_points(cor_id[(j * 2 + offset) % 8],
                            cor_id[(j * 2 + 2 + offset) % 8], z)
        for j in range(4)], 0)
    xys = xys[np.argsort(xys[:, 0])]
    return np.interp(np.arange(w), xys[:, 0], xys[:, 1], period=w)


def test_cuboid(dt_cor_id, z0, z1, gt_cor_id, w, h, losses):
    """Accumulate CE / PE / 3DIoU for one cuboid pair (eval_cuboid.py:100-145)."""
    dt_cor_id = np.asarray(dt_cor_id, np.float32)
    gt_cor_id = np.asarray(gt_cor_id, np.float32)

    # Corner error: mean L2 in pixels over the image diagonal
    mse = np.sqrt(((gt_cor_id - dt_cor_id) ** 2).sum(1)).mean()
    ce_loss = 100 * mse / np.sqrt(w ** 2 + h ** 2)

    # Pixel error: fraction of pixels with a different {ceil,wall,floor}
    # label, via cumsum of rasterized boundaries
    y0_dt = _boundary_from_corners(dt_cor_id, 0, -z0, w)
    y1_dt = infer_coory(y0_dt, z1 - z0, z0)
    y0_gt = _boundary_from_corners(gt_cor_id, 0, -z0, w)
    y1_gt = _boundary_from_corners(gt_cor_id, 1, z0, w)

    def surface_labels(y0, y1):
        s = np.zeros((h, w), np.int32)
        s[np.round(y0).astype(int), np.arange(w)] = 1
        s[np.round(y1).astype(int), np.arange(w)] = 1
        return np.cumsum(s, axis=0)

    pe_loss = 100 * (surface_labels(y0_dt, y1_dt) !=
                     surface_labels(y0_gt, y1_gt)).sum() / (h * w)

    iou3d = eval_3diou(dt_cor_id[1::2], dt_cor_id[0::2],
                       gt_cor_id[1::2], gt_cor_id[0::2])

    losses["CE"].append(ce_loss)
    losses["PE"].append(pe_loss)
    losses["3DIoU"].append(iou3d)


def prepare_gtdt_pairs(gt_glob, dt_glob):
    """Pair GT txts with DT jsons by basename (eval_cuboid.py:148-159)."""
    gt_paths = sorted(glob.glob(gt_glob))
    dt_paths = {os.path.split(v)[-1].split(".")[0]: v
                for v in glob.glob(dt_glob) if v.endswith("json")}
    return [(g, dt_paths[os.path.split(g)[-1].split(".")[0]])
            for g in gt_paths
            if os.path.split(g)[-1].split(".")[0] in dt_paths]
