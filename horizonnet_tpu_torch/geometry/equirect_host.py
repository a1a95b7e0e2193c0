"""Equirectangular pixel <-> angle <-> floor-plane transforms (host numpy).

Copy of the numpy halves of horizonnet_tpu/geometry/equirect.py that the
training labels need (data/labels.py, data/synth.py, geometry/lines.py),
the general-layout serving tail (postproc/manhattan.py, serving.py), the
host postprocess (inference.py::postprocess, in float64 as the JAX host
path) and the evals (evals/general.py), with the same conventions
(reference misc/panostretch.py and misc/post_proc.py): pixel centers at
+0.5, longitude u in (-pi, pi], "down-positive" v for the boundary and
label pipeline, "up-positive" v for the floor-plane projection.
geometry/equirect.py is the torch half, in float32 for the device fit;
the host path must not use it, since float32 picks other vote spans near
the tolerance.
"""

import math

import numpy as np

PI = math.pi


def coorx2u(x, w=1024):
    """Pixel column -> longitude. Ref: misc/panostretch.py:28."""
    return ((x + 0.5) / w - 0.5) * (2 * PI)


def coory2v(y, h=512):
    """Pixel row -> down-positive latitude. Ref: misc/panostretch.py:32."""
    return ((y + 0.5) / h - 0.5) * PI


def coory2v_up(y, h=512):
    """Pixel row -> up-positive latitude. Ref: misc/post_proc.py:26."""
    return -((y + 0.5) / h - 0.5) * PI


def u2coorx(u, w=1024):
    """Longitude -> pixel column. Ref: misc/panostretch.py:36."""
    return (u / (2 * PI) + 0.5) * w - 0.5


def v2coory(v, h=512):
    """Down-positive latitude -> pixel row. Ref: misc/panostretch.py:40."""
    return (v / PI + 0.5) * h - 0.5


def uv2xy(u, v, z=-50):
    """(u, down-positive v) on a horizontal plane at height z -> plan
    (x, y) = c (cos u, sin u), c = z / tan(v). Ref: panostretch.py:44-48."""
    c = z / np.tan(v)
    return c * np.cos(u), c * np.sin(u)


def coor2xy(coor, z=50, coorW=1024, coorH=512, floorW=1024, floorH=512):
    """Pixel (col,row) pairs (..., 2) -> floor-plane image coords,
    up-positive v. Ref: misc/post_proc.py:30-40 (np_coor2xy)."""
    coor = np.asarray(coor)
    u = coorx2u(coor[..., 0], coorW)
    v = coory2v_up(coor[..., 1], coorH)
    c = z / np.tan(v)
    x = c * np.sin(u) + floorW / 2 - 0.5
    y = -c * np.cos(u) + floorH / 2 - 0.5
    return np.stack([x, y], axis=-1)


def xy2coor(xy, z=50, coorW=1024, coorH=512, floorW=1024, floorH=512):
    """Floor-plane image coords -> pixel (col,row). Ref: post_proc.py:53-66."""
    xy = np.asarray(xy)
    x = xy[..., 0] - floorW / 2 + 0.5
    y = xy[..., 1] - floorH / 2 + 0.5
    u = np.arctan2(x, -y)
    v = np.arctan(z / np.sqrt(x ** 2 + y ** 2))
    coorx = (u / (2 * PI) + 0.5) * coorW - 0.5
    coory = (-v / PI + 0.5) * coorH - 0.5
    return np.stack([coorx, coory], axis=-1)


def x_u_solve_y(x, u, floorW=1024, floorH=512):
    """Plan y where the ray at longitude u meets the wall x = const.
    Ref: misc/post_proc.py:43-45."""
    c = (x - floorW / 2 + 0.5) / np.sin(u)
    return -c * np.cos(u) + floorH / 2 - 0.5


def y_u_solve_x(y, u, floorW=1024, floorH=512):
    """Plan x where the ray at longitude u meets the wall y = const.
    Ref: misc/post_proc.py:48-50."""
    c = -(y - floorH / 2 + 0.5) / np.cos(u)
    return c * np.sin(u) + floorW / 2 - 0.5


def infer_coory(coory0, h, z0=50, coorH=512):
    """Row of the plane at z0+h implied by the boundary rows on plane z0.
    Ref: misc/post_proc.py:126-131."""
    v0 = coory2v_up(np.asarray(coory0), coorH)
    c0 = z0 / np.tan(v0)
    v1 = np.arctan2(z0 + h, c0)
    return (-v1 / PI + 0.5) * coorH - 0.5


def get_z1(coory0, coory1, z0=50, coorH=512):
    """Height of the second plane given rows of both boundaries and z0.
    Ref: misc/post_proc.py:101-106."""
    v0 = coory2v_up(np.asarray(coory0), coorH)
    v1 = coory2v_up(np.asarray(coory1), coorH)
    c0 = z0 / np.tan(v0)
    return c0 * np.tan(v1)


def mean_percentile(vec, p1=25, p2=75):
    """Mean of the entries between the p1-th and p2-th percentiles of the
    whole array. Ref: misc/post_proc.py:69-72."""
    vmin = np.percentile(vec, p1)
    vmax = np.percentile(vec, p2)
    return vec[(vmin <= vec) & (vec <= vmax)].mean()


def refine_by_fix_z(coory0, coory1, z0=50, coorH=512):
    """Refine the second boundary assuming the first lies on plane z0.
    Returns (refined coory1, robust z1). Ref: misc/post_proc.py:109-123."""
    v0 = coory2v_up(np.asarray(coory0), coorH)
    v1 = coory2v_up(np.asarray(coory1), coorH)
    c0 = z0 / np.tan(v0)
    z1 = c0 * np.tan(v1)
    z1_mean = mean_percentile(z1)
    v1_refine = np.arctan2(z1_mean, c0)
    coory1_refine = (-v1_refine / PI + 0.5) * coorH - 0.5
    return coory1_refine, z1_mean
