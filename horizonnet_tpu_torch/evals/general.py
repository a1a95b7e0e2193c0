"""General-layout metrics: 2D/3D IoU, depth rmse / delta_1, corner buckets.

Copy of horizonnet_tpu/evals/general.py (reference eval_general.py:
56-122, test_general). The camera sits 1.6 m above the floor (ch = -1.6);
the 3D IoU treats rooms as prisms of the mean ceiling height. Results
bucket by the ground truth's corner count {4, 6, 8, 10+, odd}.
"""

import sys

import numpy as np

from ..geometry.depth import layout_2_depth
from ..geometry.equirect_host import coor2xy, get_z1
from ..geometry.polygon import (polygon_area, polygon_intersection_area,
                                polygon_is_valid)

BUCKETS = ["4", "6", "8", "10+", "odd", "overall"]


def new_general_losses():
    return {b: {"2DIoU": [], "3DIoU": [], "rmse": [], "delta_1": []}
            for b in BUCKETS}


def test_general(dt_cor_id, gt_cor_id, w, h, losses, gt_path=""):
    """Accumulate one instance's metrics into ``losses`` (in place)."""
    dt_cor_id = np.asarray(dt_cor_id, np.float32)
    gt_cor_id = np.asarray(gt_cor_id, np.float32)
    dt_floor_coor = dt_cor_id[1::2]
    dt_ceil_coor = dt_cor_id[0::2]
    gt_floor_coor = gt_cor_id[1::2]
    gt_ceil_coor = gt_cor_id[0::2]
    assert (dt_floor_coor[:, 0] != dt_ceil_coor[:, 0]).sum() == 0
    assert (gt_floor_coor[:, 0] != gt_ceil_coor[:, 0]).sum() == 0

    ch = -1.6
    dt_floor_xy = coor2xy(dt_floor_coor, ch, 1024, 512, floorW=1, floorH=1)
    gt_floor_xy = coor2xy(gt_floor_coor, ch, 1024, 512, floorW=1, floorH=1)

    # the reference skips instances whose ground-truth polygon is invalid
    # (eval_general.py:71-73)
    if not polygon_is_valid(gt_floor_xy):
        print(f"Skip ground truth invalid ({gt_path})", file=sys.stderr)
        return

    try:
        area_dt = polygon_area(dt_floor_xy)
        area_gt = polygon_area(gt_floor_xy)
        area_inter = polygon_intersection_area(dt_floor_xy, gt_floor_xy)
        iou2d = area_inter / (area_gt + area_dt - area_inter)
    except Exception:
        iou2d = 0
        area_inter = area_dt = area_gt = 0.0

    try:
        cch_dt = get_z1(dt_floor_coor[:, 1], dt_ceil_coor[:, 1], ch, 512)
        cch_gt = get_z1(gt_floor_coor[:, 1], gt_ceil_coor[:, 1], ch, 512)
        h_dt = abs(cch_dt.mean() - ch)
        h_gt = abs(cch_gt.mean() - ch)
        area3d_inter = area_inter * min(h_dt, h_gt)
        area3d_pred = area_dt * h_dt
        area3d_gt = area_gt * h_gt
        iou3d = area3d_inter / (area3d_pred + area3d_gt - area3d_inter)
    except Exception:
        iou3d = 0

    gt_layout_depth = layout_2_depth(gt_cor_id, h, w)
    try:
        dt_layout_depth = layout_2_depth(dt_cor_id, h, w)
    except Exception:
        dt_layout_depth = np.zeros_like(gt_layout_depth)
    rmse = ((gt_layout_depth - dt_layout_depth) ** 2).mean() ** 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        thres = np.maximum(gt_layout_depth / dt_layout_depth,
                           dt_layout_depth / gt_layout_depth)
    delta_1 = (thres < 1.25).mean()

    n_corners = len(gt_floor_coor)
    if n_corners % 2 == 1:
        bucket = "odd"
    elif n_corners < 10:
        bucket = str(n_corners)
    else:
        bucket = "10+"
    for b in (bucket, "overall"):
        losses[b]["2DIoU"].append(iou2d)
        losses[b]["3DIoU"].append(iou3d)
        losses[b]["rmse"].append(rmse)
        losses[b]["delta_1"].append(delta_1)


def summarize_general(losses, stream=None):
    """Print the reference's report format (eval_general.py:162-173)."""
    stream = stream or sys.stdout
    out = {}
    for k, result in losses.items():
        if len(result["2DIoU"]) == 0:
            continue
        out[k] = {m: float(np.mean(result[m])) for m in result}
        print(f"GT #Corners: {k}  ({len(result['2DIoU'])} instances)",
              file=stream)
        print("    2DIoU  : %.2f" % (out[k]["2DIoU"] * 100), file=stream)
        print("    3DIoU  : %.2f" % (out[k]["3DIoU"] * 100), file=stream)
        print("    RMSE   : %.2f" % out[k]["rmse"], file=stream)
        print("    delta^1: %.2f" % out[k]["delta_1"], file=stream)
    return out
