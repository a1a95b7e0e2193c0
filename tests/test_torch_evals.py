"""The port's evals and the geometry under them against the JAX package.

Polygon intersection, layout depth and the general-layout metrics are
float64 numpy on both sides, on the same seeded inputs: the bar is exact
equality.
"""

import io

import numpy as np
import pytest

from horizonnet_tpu.evals import general as jax_general
from horizonnet_tpu.geometry import depth as jax_depth
from horizonnet_tpu.geometry import polygon as jp
from horizonnet_tpu_torch.data.synth import synth_room
from horizonnet_tpu_torch.evals import general
from horizonnet_tpu_torch.geometry import depth
from horizonnet_tpu_torch.geometry import polygon as pp
from tests.test_evals import _synthetic_cuboid


def _ring(rng, n, r0=5.0):
    """A star-shaped (simple) polygon of n vertices around a random
    centre, possibly non-convex, in a random orientation."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r0 * rng.uniform(0.4, 1.0, n)
    pts = np.stack([np.cos(ang) * rad, np.sin(ang) * rad], -1)
    pts += rng.uniform(-2, 2, 2)
    return pts[::-1] if rng.uniform() < 0.5 else pts


def _convex(rng, n):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    return np.stack([np.cos(ang), np.sin(ang)], -1) * 4 + rng.uniform(-1, 1, 2)


@pytest.mark.parametrize("seed", range(4))
def test_polygon_functions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    p, q = _ring(rng, 7 + seed), _ring(rng, 5 + 2 * seed)
    assert pp.signed_polygon_area(p) == jp.signed_polygon_area(p)
    for a, b in zip(pp._segments(p), jp._segments(p)):
        np.testing.assert_array_equal(a, b)
    cp, cq = _convex(rng, 6), _convex(rng, 5)
    np.testing.assert_array_equal(pp._clip_convex(cp, cq[0], cq[1]),
                                  jp._clip_convex(cp, cq[0], cq[1]))
    assert pp.convex_intersection_area(cp, cq) == \
        jp.convex_intersection_area(cp, cq)
    got, want = pp._fan_triangles(p), jp._fan_triangles(p)
    assert got[1] == want[1]
    np.testing.assert_array_equal(np.stack(got[0]), np.stack(want[0]))
    tris = np.stack(pp._fan_triangles(p if pp.signed_polygon_area(p) > 0
                                      else p[::-1])[0])
    clip = np.stack(pp._fan_triangles(q if pp.signed_polygon_area(q) > 0
                                      else q[::-1])[0])[0]
    np.testing.assert_array_equal(pp._tri_tri_intersection_areas(tris, clip),
                                  jp._tri_tri_intersection_areas(tris, clip))
    assert pp.polygon_intersection_area(p, q) == \
        jp.polygon_intersection_area(p, q)
    assert pp.polygon_iou(p, q) == jp.polygon_iou(p, q)
    assert pp.polygon_iou(p, p + 100) == jp.polygon_iou(p, p + 100) == 0.0


def test_polygon_intersection_known_areas():
    sq = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float64)
    assert pp.polygon_intersection_area(sq, sq + [1, 1]) == \
        pytest.approx(1.0)
    ell = np.array([[0, 0], [3, 0], [3, 1], [1, 1], [1, 3], [0, 3]], float)
    assert pp.polygon_intersection_area(ell, sq) == pytest.approx(3.0)
    assert pp.polygon_iou(sq, sq) == pytest.approx(1.0)


@pytest.mark.parametrize("seed", range(3))
def test_layout_2_depth_equals_jax(seed):
    _, cor = synth_room(np.random.default_rng(seed), 256, 512)
    got = depth.layout_2_depth(cor, 256, 512, return_mask=True)
    want = jax_depth.layout_2_depth(cor, 256, 512, return_mask=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _general_pairs():
    """(dt, gt) pixel corner lists at 1024x512: tests/test_evals.py's
    cuboid rooms (shifted, identical), synthetic L-rooms against their
    noisy copies, a cuboid against an L-room, and a detection that is
    not a layout (the metrics' fallbacks)."""
    pairs = [(_synthetic_cuboid(), _synthetic_cuboid(dx=1.0)),
             (_synthetic_cuboid(dx=0.5, dy=0.3, w=2.5),
              _synthetic_cuboid()),
             (_synthetic_cuboid(), _synthetic_cuboid())]
    rng = np.random.default_rng(7)
    for k in range(3):
        _, gt = synth_room(rng, general_p=1.0)
        dt = gt + np.repeat(rng.normal(0, 2, (len(gt) // 2, 2)), 2, 0) \
            * [1, 0] + rng.normal(0, 2, gt.shape) * [0, 1]
        pairs.append((dt, gt))
    _, l_room = synth_room(rng, general_p=1.0)
    pairs.append((_synthetic_cuboid(), l_room))
    bad = _synthetic_cuboid()
    bad[1::2, 1] = 200.0                       # floor above the horizon
    pairs.append((bad, _synthetic_cuboid()))
    return pairs


def test_test_general_equals_jax():
    got, want = general.new_general_losses(), jax_general.new_general_losses()
    for dt, gt in _general_pairs():
        general.test_general(dt, gt, 1024, 512, got)
        jax_general.test_general(dt, gt, 1024, 512, want)
    assert got == want
    assert len(got["overall"]["2DIoU"]) == len(_general_pairs())
    assert got["4"]["2DIoU"] and got["6"]["3DIoU"]
    assert got["overall"]["2DIoU"][2] == pytest.approx(1.0)
    s_got, s_want = io.StringIO(), io.StringIO()
    assert general.summarize_general(got, s_got) == \
        jax_general.summarize_general(want, s_want)
    assert s_got.getvalue() == s_want.getvalue()


def test_test_general_skips_invalid_ground_truth(capsys):
    gt = _synthetic_cuboid()
    gt[0::2] = gt[0::2][[0, 2, 1, 3]]       # a bow-tie floor plan
    gt[1::2] = gt[1::2][[0, 2, 1, 3]]
    got = general.new_general_losses()
    general.test_general(_synthetic_cuboid(), gt, 1024, 512, got)
    assert got == general.new_general_losses()
    assert "Skip ground truth invalid" in capsys.readouterr().err
