"""Analytic layout -> per-pixel depth (host numpy).

Copy of horizonnet_tpu/geometry/depth.py, for the general evals' rmse and
delta_1 (reference eval_general.py:14-53, layout_2_depth).
"""

import numpy as np

from .lines import cor_2_1d


def layout_2_depth(cor_id, h, w, return_mask=False, floor_h=1.6):
    """Render the depth of a layout: floor and ceiling planes and
    vertical walls, the camera ``floor_h`` meters above the floor.
    ``cor_id`` is the (2N, 2) pixel corner list, ceiling and floor
    interleaved. Ref: eval_general.py:14-53."""
    vc, vf = cor_2_1d(cor_id, h, w)  # down-positive latitude per column
    vc = vc[None, :]
    vf = vf[None, :]
    assert (vc > 0).sum() == 0, "ceiling boundary must be above the horizon"
    assert (vf < 0).sum() == 0, "floor boundary must be below the horizon"

    # per-pixel down-positive latitude
    vs = ((np.arange(h) + 0.5) / h - 0.5) * np.pi
    vs = np.repeat(vs[:, None], w, axis=1)

    floor_d = np.abs(floor_h / np.sin(vs))
    cs = floor_h / np.tan(vf)                 # horizontal wall distance
    ceil_h = np.abs(cs * np.tan(vc))          # ceiling height per column
    ceil_d = np.abs(ceil_h / np.sin(vs))
    wall_d = np.abs(cs / np.cos(vs))

    floor_mask = vs > vf
    ceil_mask = vs < vc
    wall_mask = (~floor_mask) & (~ceil_mask)
    depth = np.zeros([h, w], np.float32)
    depth[floor_mask] = floor_d[floor_mask]
    depth[ceil_mask] = ceil_d[ceil_mask]
    depth[wall_mask] = wall_d[wall_mask]

    assert (depth == 0).sum() == 0, "degenerate layout produced zero depth"
    if return_mask:
        return depth, floor_mask, ceil_mask, wall_mask
    return depth
