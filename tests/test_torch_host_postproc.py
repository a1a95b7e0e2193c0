"""The port's host postprocess against the JAX package, on the CPU.

Both sides are float64 numpy on the same inputs (made from a seed), so the
bar is exact equality: the equirect helpers, the Manhattan wall fit (with
the greedy ring's branches), ``postprocess`` on synthetic-room and random
outputs in every mode, and the raw-output strip.
"""

import contextlib
import io

import numpy as np
import pytest

from horizonnet_tpu.geometry import equirect as jeq
from horizonnet_tpu.inference import postprocess as jax_postprocess
from horizonnet_tpu.postproc import manhattan as jm
from horizonnet_tpu.viewer.visualize import visualize_a_data as jax_vis
from horizonnet_tpu_torch.data.synth import synth_room
from horizonnet_tpu_torch.geometry import equirect_host as eq
from horizonnet_tpu_torch.geometry.lines import cor_2_1d
from horizonnet_tpu_torch.inference import postprocess
from horizonnet_tpu_torch.postproc import manhattan as m
from horizonnet_tpu_torch.viewer.visualize import visualize_a_data
from tests.test_manhattan_branches import _xy_for_segments

H, W = 512, 1024


def _walls(walls):
    return [(w.axis, w.value, w.score, w.seg, w.u0, w.u1, w.pending,
             w.origin) for w in walls]


def _ceiling_rows(rng, n=W):
    """A noisy ceiling boundary (pixel rows) of a synthetic room."""
    _, cor = synth_room(rng, H, n)
    bon = cor_2_1d(cor, H, n)
    rows = (bon[0] / np.pi + 0.5) * H - 0.5 + rng.normal(0, 0.5, n)
    return np.clip(rows, 1, H / 2 - 1), cor


def test_equirect_host_functions_equal_jax():
    rng = np.random.default_rng(0)
    coor = np.stack([rng.uniform(0, W, 300), rng.uniform(1, H - 2, 300)], -1)
    np.testing.assert_array_equal(eq.coor2xy(coor),
                                  jeq.coor2xy(coor))
    np.testing.assert_array_equal(
        eq.coor2xy(coor.astype(np.float32), -1.6, 1024, 512, 1, 1),
        jeq.coor2xy(coor.astype(np.float32), -1.6, 1024, 512, 1, 1))
    y0 = rng.uniform(1, H / 2 - 1, 300)
    y1 = rng.uniform(H / 2 + 1, H - 2, 300)
    np.testing.assert_array_equal(eq.get_z1(y0, y1), jeq.get_z1(y0, y1))
    np.testing.assert_array_equal(eq.get_z1(y0, y1, -1.6, 512),
                                  jeq.get_z1(y0, y1, -1.6, 512))
    vec = rng.normal(size=301)
    assert eq.mean_percentile(vec) == jeq.mean_percentile(vec)
    assert eq.mean_percentile(vec, 10, 60) == jeq.mean_percentile(vec, 10, 60)
    got, want = eq.refine_by_fix_z(y0, y1), jeq.refine_by_fix_z(y0, y1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("seed", range(3))
def test_manhattan_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    fuv = rng.normal(size=W)
    np.testing.assert_array_equal(m.fuv2img(fuv, floorW=64, floorH=32),
                                  jm.fuv2img(fuv, floorW=64, floorH=32))
    xy = rng.normal(size=(40, 2)) * 10
    assert m.gpid_two_split(xy, 0, 1) == jm.gpid_two_split(xy, 0, 1)
    for px, py in rng.normal(size=(8, 2)):
        assert m._principal_rot_deg(px, py) == jm._principal_rot_deg(px, py)
    rows, cor = _ceiling_rows(rng)
    xs = np.round(cor[0::2, 0]).astype(int)
    assert m.get_rot_rad(xs, rows) == jm.get_rot_rad(xs, rows)
    np.testing.assert_array_equal(m.get_gpid(xs, W), jm.get_gpid(xs, W))
    np.testing.assert_array_equal(m.get_gpid(np.array([3.4, 500.6]), W),
                                  jm.get_gpid(np.array([3.4, 500.6]), W))


@pytest.mark.parametrize("seed", range(4))
def test_vote_equals_jax_with_ties_and_fallback(seed):
    """Rounded values make equal spans (the flat argmax's tie order);
    short and spread vectors take the median fallback (``m < tol``)."""
    rng = np.random.default_rng(seed)
    cases = [np.round(rng.uniform(0, 10, 60)), rng.normal(0, 1, 50),
             rng.uniform(0, 1000, 20), rng.normal(0, 0.1, 3)]
    for vec in cases:
        for tol in (0.5, 3, 5):
            assert m.vote(vec, tol) == jm.vote(vec, tol)


@pytest.mark.parametrize("seed", range(4))
def test_gen_ww_equals_jax(seed):
    """Synthetic rooms (cuboid and L-shaped) through the cuboid and the
    general fit, from the true corner columns and from shifted ones."""
    rng = np.random.default_rng(seed)
    rows, cor = _ceiling_rows(rng)
    xs = np.sort(np.round(cor[0::2, 0]).astype(int))
    for init in (xs, np.sort((xs + rng.integers(-8, 9, len(xs))) % W)):
        for force_cuboid in (True, False):
            if force_cuboid and len(init) != 4:
                continue
            got = m.gen_ww(init, rows, tol=3, force_cuboid=force_cuboid)
            want = jm.gen_ww(init, rows, tol=3, force_cuboid=force_cuboid)
            np.testing.assert_array_equal(got[0], want[0])
            assert _walls(got[1]) == _walls(want[1])
    coor = np.stack([np.arange(W), rows], -1)
    xy = eq.coor2xy(coor)
    gpid = m.get_gpid(xs, W)
    for j in range(len(xs)):
        assert _walls([m._segment_candidate(xy, gpid, j, 3)]) == \
            _walls([jm._segment_candidate(xy, gpid, j, 3)])
    if len(xs) == 4:
        assert _walls(m.gen_ww_cuboid(xy, gpid, 3)) == \
            _walls(jm.gen_ww_cuboid(xy, gpid, 3))


BRANCH_SPECS = {
    "flip_three_same_type": [(0, 400.0, 0.0), (0, 500.0, 1.0),
                             (0, 600.0, 0.0), (1, 300.0, 0.5)],
    "insert_between_mixed": [(0, 400.0, 0.0), (0, 480.0, 60.0),
                             (1, 350.0, 0.1), (0, 650.0, 0.2),
                             (1, 200.0, 0.3)],
    "defer_then_insert": [(0, 400.0, 0.0), (0, 500.0, 2.0), (0, 600.0, 4.0)],
    "plain_alternating": [(0, 400.0, 0.1), (1, 350.0, 0.1), (0, 650.0, 0.1),
                          (1, 150.0, 0.1)],
}


@pytest.mark.parametrize("case", sorted(BRANCH_SPECS))
def test_gen_ww_general_branches_equal_jax(case):
    """tests/test_manhattan_branches.py's crafted inputs: the greedy
    ring's flip, corner insertion and deferral give JAX's walls."""
    init_coorx, xy, gpid = _xy_for_segments(BRANCH_SPECS[case])
    got = m.gen_ww_general(init_coorx, xy, gpid, tol=20)
    want = jm.gen_ww_general(init_coorx, xy, gpid, tol=20)
    assert _walls(got) == _walls(want)
    origins = {w.origin for w in got}
    expect = {"flip_three_same_type": "flipped",
              "insert_between_mixed": "inferred",
              "plain_alternating": "vote"}.get(case)
    if expect:
        assert expect in origins
    assert all(not w.pending for w in got)


def _room_outputs(rng, general_p):
    """Model-like raw outputs of a synthetic room: the true boundary in
    radians with noise, and a corner heatmap with noise."""
    _, cor = synth_room(rng, H, W, general_p=general_p)
    bon = cor_2_1d(cor, H, W) + rng.normal(0, 3e-3, (2, W))
    dist = np.abs(np.arange(W)[:, None] - cor[0::2, 0][None])
    dist = np.minimum(dist, W - dist).min(1)
    y_cor = np.exp(-dist ** 2 / 50.0) + rng.uniform(0, 0.05, W)
    return bon, np.clip(y_cor, 0, 1)


def _random_outputs(rng):
    bon = np.stack([rng.uniform(-1.2, -0.2, W), rng.uniform(0.2, 1.2, W)])
    return bon, rng.uniform(0, 1, W)


MODES = {
    "cuboid": dict(force_cuboid=True),
    "general": dict(),
    "force_raw": dict(force_raw=True),
    "min_v_r": dict(min_v=0.3, r=0.1),
    "cuboid_min_v_r": dict(force_cuboid=True, min_v=0.2, r=0.02),
}


def _postprocess_both(bon, y_cor, **kw):
    errs = []
    for fn in (postprocess, jax_postprocess):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            errs.append(fn(bon, y_cor, H, W, **kw))
        errs[-1] += (err.getvalue(),)
    return errs


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("source", ["cuboid_room", "general_room",
                                    "random"])
def test_postprocess_equals_jax(source, mode):
    for seed in range(3):
        rng = np.random.default_rng([seed, len(source), len(mode)])
        if source == "random":
            bon, y_cor = _random_outputs(rng)
        else:
            bon, y_cor = _room_outputs(
                rng, 1.0 if source == "general_room" else 0.0)
        got, want = _postprocess_both(bon, y_cor, **MODES[mode])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if mode == "force_raw":
            assert got[0].shape == (2 * W, 2)


def test_postprocess_invalid_general_layout_falls_back_to_cuboid():
    """Random outputs whose general fit self-intersects: both packages
    print the fallback line and return the same cuboid."""
    hits = 0
    for seed in range(40):
        bon, y_cor = _random_outputs(np.random.default_rng(seed))
        got, want = _postprocess_both(bon, y_cor)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if "Generate cuboid as fallback" in got[3]:
            hits += 1
            assert got[0].shape == (8, 2)
    assert hits > 0, "no seed reached the fallback"


def test_visualize_a_data_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    bon = np.stack([rng.uniform(-1.6, 0, 128), rng.uniform(0, 1.6, 128)])
    y_cor = rng.uniform(-0.2, 1.2, 128)
    got = visualize_a_data(x, bon, y_cor)
    assert got.shape == (33 + 64, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_vis(x, bon, y_cor))
