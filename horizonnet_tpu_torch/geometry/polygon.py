"""2D segment intersection (host numpy), for the occlusion labels.

Copy of horizonnet_tpu/geometry/polygon.py::point_segments_intersect (the
reference's shapely raycast, dataset.py:172-186).
"""

import numpy as np

_EPS = 1e-12


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
