"""The port's preprocess branch against the JAX package, on the CPU.

The same numpy inputs (from a seed, or the committed val_room.png and
rotations of it by a known R) go through horizonnet_tpu's preprocess and
horizonnet_tpu_torch's. Bars:
- the copied numpy and C++ (sphere, LSD, merge, triple search, lines,
  Hough, the host warps, the host-backend pipeline): equal to the bit, as
  the same code built with the same flags on one machine;
- the torch device backend on the CPU against JAX's device backend on the
  CPU: JAX's own bars between its two backends (tests/test_host_resample.py):
  grays 0.15, RGB views 0.2, float rotation mean 0.05, uint8 rotation
  under 1 % of pixels; the pipeline's VP rows within 0.01 deg;
- a known rotation recovered: the vertical VP within 0.1 deg of R vp0,
  the horizontals within 1.5 deg (the room gives 2-3 lines).
"""

import os

import numpy as np
import pytest
import torch

from horizonnet_tpu.preprocess import host_resample as jhr
from horizonnet_tpu.preprocess import lines as jlines
from horizonnet_tpu.preprocess import native as jnative
from horizonnet_tpu.preprocess import rotate as jrotate
from horizonnet_tpu.preprocess import sphere as jsphere
from horizonnet_tpu.preprocess import vanishing as jvan
from horizonnet_tpu.preprocess import views as jviews
from horizonnet_tpu.preprocess.lsd import lsd as j_lsd, lsd_batch as j_lsd_b
from horizonnet_tpu.preprocess.pipeline import pano_edge_detection as j_ped
from horizonnet_tpu_torch.ops.resample import (bilinear_wrap_sample,
                                               bilinear_wrap_sample_one)
from horizonnet_tpu_torch.preprocess import host_resample as hr
from horizonnet_tpu_torch.preprocess import lines, native, rotate, sphere
from horizonnet_tpu_torch.preprocess import vanishing, views
from horizonnet_tpu_torch.preprocess.lsd import lsd, lsd_batch
from horizonnet_tpu_torch.preprocess.pipeline import pano_edge_detection
from horizonnet_tpu_torch.utils.image import read_png, write_png

PANO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "golden", "val_room.png")
# (yaw, tilt) in degrees of the raw rooms: val_room turned by R
ROTATIONS = {"room": (0, 0), "yaw20_tilt8": (20, 8), "yaw-35_tilt5": (-35, 5)}


def yaw_tilt(yaw, tilt):
    a, b = np.radians(yaw), np.radians(tilt)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    return Rz @ Rx


def raw_rooms():
    """name -> (uint8 [512, 1024, 3] raw pano, R): val_room rotated by R
    with the host warp, so that a feature at direction p moves to R p."""
    room = read_png(PANO)[..., :3]
    out = {}
    for name, (yaw, tilt) in ROTATIONS.items():
        R = yaw_tilt(yaw, tilt)
        out[name] = (room if name == "room" else
                     hr.rotate_panorama_uint8_host(room, R=R), R)
    return out


def vp_angles(a, b):
    """Degrees between the directions of rows a and b, up to sign
    (broadcasts); by atan2, which stays exact near 0 where arccos of a
    rounded dot product does not."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    a, b = np.broadcast_arrays(a, b)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                                 np.abs((a * b).sum(-1))))


def vp_rows_deg(a, b):
    """Degrees from each VP row of a to b's: the vertical (row 0) to b's
    vertical, each horizontal to the nearer of b's two (their order flips
    where find_main_direction's |sin u| ordering nearly ties, as for a
    room at 45 deg of yaw)."""
    return [vp_angles(a[0], b[0])] + [vp_angles(a[k], b[1:3]).min()
                                      for k in (1, 2)]


@pytest.fixture(scope="module")
def rooms():
    return raw_rooms()


@pytest.fixture(autouse=True)
def _default_backend(monkeypatch):
    monkeypatch.delenv("HORIZONNET_PREPROCESS_BACKEND", raising=False)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _merge_fodder(rng):
    """Per-view lifted segments with thousands of near-collinear pairs:
    two overlapping pieces of one image line plus an unrelated segment
    (tests/test_preprocess.py's merge input)."""
    xs, ys = views.VIEW_DIRECTIONS
    lifted = []
    for i in range(len(xs)):
        n = int(rng.integers(10, 30))
        p1 = rng.uniform(40, 280, (n, 2))
        d = rng.normal(0, 40, (n, 2))
        rows = []
        for k in range(n):
            rows.append([*p1[k], *(p1[k] + d[k])])
            rows.append([*(p1[k] + 0.4 * d[k]), *(p1[k] + 1.6 * d[k])])
            q = rng.uniform(20, 300, 2)
            rows.append([*q, *(q + rng.normal(0, 30, 2))])
        seg = np.asarray(rows)
        seg = np.hstack([seg, np.full((len(seg), 1), 2.0),
                         np.ones((len(seg), 2))])
        lifted.append(lines.lift_segments_to_sphere(
            seg, xs[i], ys[i], np.pi / 3, (320, 320)))
    return lifted


def _manhattan_lines(rng, n_per_axis=60):
    """(N, 8) lines whose normals are perpendicular to one of 3 orthogonal
    axes (lines pointing at 3 VPs), with noise."""
    normals = []
    for ax in np.eye(3):
        for _ in range(n_per_axis):
            r = rng.normal(size=3)
            n = r - np.dot(r, ax) * ax
            n = n / np.linalg.norm(n) + rng.normal(scale=0.01, size=3)
            normals.append(n / np.linalg.norm(n))
    out = np.zeros((len(normals), 8))
    out[:, :3] = normals
    out[:, 3] = rng.integers(1, 4, len(out))
    a = rng.uniform(0, 1, len(out))
    out[:, 4] = a
    out[:, 5] = np.mod(a + rng.uniform(0.02, 0.3, len(out)), 1.0)
    out[:, 6] = rng.uniform(0.1, 0.5, len(out))
    out[:, 7] = 1.0
    return out


# --- the copied numpy and C++: equal to the bit ---------------------------

def _sphere_cases(rng):
    xyz = _unit(rng, 50)
    n = _unit(rng, 4)
    u = rng.uniform(-np.pi, np.pi, (8, 1))
    plane = np.array([1, 2, 3, 1])
    uS = rng.uniform(-np.pi, np.pi, (4, 16))
    pts = xyz - np.outer(xyz @ n[0], n[0])
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    cases = {f"xyz2uvN_{p}": ("xyz2uvN", (xyz, p)) for p in (1, 2, 3)}
    cases.update({f"uv2xyzN_{p}": ("uv2xyzN", (jsphere.xyz2uvN(xyz, p), p))
                  for p in (1, 2, 3)})
    cases.update({f"computeUVN_{p}": ("computeUVN", (n[0], u, p))
                  for p in (1, 2, 3)})
    cases.update({
        "xyz2uvN_vec": ("xyz2uvN_vec", (xyz[:8], np.repeat(plane, 2))),
        "uv2xyzN_vec": ("uv2xyzN_vec", (u[:, [0, 0]], np.repeat(plane, 2))),
        "computeUVN_vec": ("computeUVN_vec", (n, u, plane)),
        "computeUVN_batch": ("computeUVN_batch", (n, uS, plane)),
        "great_circle_xyz_batch": ("great_circle_xyz_batch", (n, uS, plane)),
        "uv2xyzN_batch": ("uv2xyzN_batch", (uS, uS / 3, plane)),
        "icosahedron2sphere_0": ("icosahedron2sphere", (0,)),
        "icosahedron2sphere_5": ("icosahedron2sphere", (5,)),
        "fit_plane_normal": ("fit_plane_normal", (pts, np.ones((50, 1)))),
    })
    return cases


SPHERE_CASES = sorted(_sphere_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("case", SPHERE_CASES)
def test_sphere_equals_jax(case):
    fn, args = _sphere_cases(np.random.default_rng(0))[case]
    got, want = getattr(sphere, fn)(*args), getattr(jsphere, fn)(*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        np.testing.assert_array_equal(g, w)


def test_uv_xyz_roundtrip_and_great_circle():
    rng = np.random.default_rng(1)
    xyz = _unit(rng, 50)
    n = _unit(rng, 1)[0]
    u = rng.uniform(-np.pi, np.pi, (20, 1))
    for p in (1, 2, 3):
        np.testing.assert_allclose(
            sphere.uv2xyzN(sphere.xyz2uvN(xyz, p), p), xyz, atol=1e-9)
        on = sphere.uv2xyzN(np.hstack([u, sphere.computeUVN(n, u, p)]), p)
        np.testing.assert_allclose(on @ n, 0, atol=1e-6)
    pts, tri = sphere.icosahedron2sphere(3)
    assert pts.shape == (642, 3) and tri.shape[1] == 3


@pytest.mark.parametrize("r1,r2", [((0.9, 0.1), (0.95, 0.05)),
                                   ((0.2, 0.4), (0.3, 0.5)),
                                   ((0.2, 0.3), (0.5, 0.6)),
                                   ((0.9, 0.1), (0.5, 0.6))])
def test_range_helpers_equal_jax(r1, r2):
    assert lines._range_intersects(r1, r2) == \
        jlines._range_intersects(r1, r2)
    for pt in (0.05, 0.5, 0.95):
        assert lines._inside_range(pt, r1) == jlines._inside_range(pt, r1)


def test_lift_and_parameterize_equal_jax():
    rng = np.random.default_rng(2)
    seg = np.hstack([rng.uniform(0, 320, (40, 4)), np.full((40, 1), 2.0),
                     np.ones((40, 2))])
    got = lines.lift_segments_to_sphere(seg, 0.3, 0.2, np.pi / 3, (320, 320))
    want = jlines.lift_segments_to_sphere(seg, 0.3, 0.2, np.pi / 3,
                                          (320, 320))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lines.segments_to_lines(got),
                                  jlines.segments_to_lines(want))
    n, c1 = got[:, :3], got[:, 3:6]
    assert np.abs((n * c1).sum(1)).max() < 1e-6 * np.abs(c1).max()


def test_lsd_batch_on_val_room_views_equals_jax(rooms):
    """The 26 grays of val_room at the pipeline's 320 px through the
    native thread pool, and one view through the single-image entry."""
    grays = hr.cut_views_gray_host(rooms["room"][0])
    got = lsd_batch(grays, quant=0.7)
    want = j_lsd_b(grays, quant=0.7)
    assert sum(len(s) for s in got) > 0
    assert len(got) == len(want) == 26
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(lsd(grays[3], quant=0.7),
                                  j_lsd(grays[3], quant=0.7))


def test_merge_rounds_and_twin_equal_jax():
    lifted = _merge_fodder(np.random.default_rng(11))
    merged, ori = lines.combine_edges(lifted)
    j_merged, _ = jlines.combine_edges(lifted)
    assert len(merged) < len(ori)        # merging happened
    # the port's originals are the unmerged lines: JAX's binding merges in
    # the caller's array, so its second output is overwritten
    np.testing.assert_array_equal(
        ori, jlines.segments_to_lines(np.vstack(lifted)))
    np.testing.assert_array_equal(merged, j_merged)
    np.testing.assert_array_equal(native.merge_rounds(ori),
                                  jnative.merge_rounds(ori.copy()))
    events, j_events = [], []
    py = lines._merge_rounds_py(ori, events=events)
    np.testing.assert_array_equal(py, jlines._merge_rounds_py(
        ori, events=j_events))
    assert events == j_events and len(events) > 50
    # the C++ engine makes the numpy spec's decisions
    np.testing.assert_array_equal(merged[:, 3:6], py[:, 3:6])
    assert merged.shape == py.shape


def test_merge_event_stream_native_equals_numpy():
    """merge.cpp's event-recording entry: the same (round, i, j)
    absorptions as the numpy spec."""
    import ctypes

    ori = lines.combine_edges(_merge_fodder(np.random.default_rng(12)))[1]
    events = []
    lines._merge_rounds_py(ori, events=events)
    lib = native._load()
    lib.combine_edges_merge_ev.restype = ctypes.c_int
    lib.combine_edges_merge_ev.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    buf = np.ascontiguousarray(ori, np.float64).copy()
    ev = np.zeros((100000, 3), np.int32)
    ev_n = ctypes.c_int(0)
    m = lib.combine_edges_merge_ev(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(buf), 3,
        ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(ev),
        ctypes.byref(ev_n))
    assert [tuple(r) for r in ev[:ev_n.value]] == events
    assert m == len(native.merge_rounds(ori))


@pytest.mark.parametrize("trial", range(4))
def test_search_triples_and_twin_equal_jax(trial):
    rng = np.random.default_rng(trial)
    orth_cos = np.cos((90 - 2) * np.pi / 180)
    third_cos = np.cos(2 * np.pi / 180)
    n = int(rng.integers(50, 400))
    bins = _unit(rng, n)
    votes = np.where(rng.uniform(size=n) < 0.8,
                     rng.integers(0, 8, n).astype(np.float64), 0.0)
    check1 = rng.permutation(n)[:n // 2].astype(np.int32)
    force = trial % 2 == 0
    nonzero = votes > 0 if force else np.ones(n, bool)
    args = (bins, votes, check1, nonzero, orth_cos, third_cos, force)
    for got, want in ((native.search_triples(*args),
                       jnative.search_triples(*args)),
                      (vanishing._search_triples_py(*args),
                       jvan._search_triples_py(*args))):
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(np.asarray(got[2], float),
                                      np.asarray(want[2], float))
        np.testing.assert_array_equal(np.asarray(got[3], float),
                                      np.asarray(want[3], float))
    a, b = native.search_triples(*args), vanishing._search_triples_py(*args)
    assert a[0] == b[0] and np.isclose(a[1], b[1])


def test_sphere_hough_and_main_direction_equal_jax():
    lns = _manhattan_lines(np.random.default_rng(4))
    candi, _ = sphere.icosahedron2sphere(3)
    args = (lns[:, :3], lns[:, [6]], np.ones((len(lns), 1)), 4.0, 2, candi)
    vp, _, _ = vanishing.sphere_hough_vote(*args)
    j_vp, _, _ = jvan.sphere_hough_vote(*args)
    np.testing.assert_array_equal(vp, j_vp)
    assert (np.abs(np.eye(3) @ vp.T).max(0) > 0.99).all()
    main, score, angle = vanishing.find_main_direction(lns)
    j_main, j_score, j_angle = jvan.find_main_direction(lns)
    np.testing.assert_array_equal(main, j_main)
    assert main.shape == (6, 3) and score == j_score
    np.testing.assert_array_equal(angle, j_angle)


def test_assign_refit_paint_equal_jax():
    rng = np.random.default_rng(7)
    lns = _manhattan_lines(rng, 40)
    vp = np.eye(3)
    tp, cost = lines.assign_vanishing_type(lns, vp, 0.1, 10)
    j_tp, j_cost = jlines.assign_vanishing_type(lns, vp, 0.1, 10)
    np.testing.assert_array_equal(tp, j_tp)
    np.testing.assert_array_equal(cost, j_cost)
    for k in range(3):
        g = lns[tp == k]
        np.testing.assert_array_equal(
            lines.refit_line_segments(g, vp[k], 0),
            jlines.refit_line_segments(g, vp[k], 0))
    np.testing.assert_array_equal(lines.paint_parameter_lines(lns, 256, 128),
                                  jlines.paint_parameter_lines(lns, 256, 128))


def test_near_vp_closed_form_equals_jax_and_oracle():
    rng = np.random.default_rng(3)
    for _ in range(10):
        n = int(rng.integers(1, 300))
        a = _unit(rng, n)
        b = a + rng.uniform(0.05, 1.8) * rng.normal(size=(n, 3))
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        vp = _unit(rng, 3)
        c = np.cos(np.deg2rad(rng.uniform(1.0, 45.0)))
        got = lines._near_vp_any(a, b, vp, c, 100)
        np.testing.assert_array_equal(got, jlines._near_vp_any(a, b, vp, c,
                                                               100))
        np.testing.assert_array_equal(
            got, lines._near_vp_any_sampled(a, b, vp, c, 100))


@pytest.mark.parametrize("fn", ["cut_views_host", "cut_views_gray_host",
                                "rotate_panorama_host",
                                "rotate_panorama_uint8_host"])
def test_host_warps_equal_jax(fn, rooms):
    pano = rooms["room"][0]
    if fn.startswith("cut"):
        kw = dict(size=64)
        arg = pano if "gray" in fn else pano.astype(np.float64)
    else:
        kw = dict(R=yaw_tilt(20, 8))
        arg = pano if "uint8" in fn else pano.astype(np.float32) / 255
    got, want = getattr(hr, fn)(arg, **kw), getattr(jhr, fn)(arg, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_native_warp_equals_numpy_twin():
    assert hr._warp() is not None, "warp.cpp did not build"
    rng = np.random.default_rng(3)
    H, W = 37, 53
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    py = rng.uniform(-5, H + 5, (200,)).astype(np.float32)
    px = rng.uniform(-5, W + 5, (200,)).astype(np.float32)
    idx, wts = hr._bilinear_wrap_tables(py, px, H, W)
    np.testing.assert_array_equal(hr._warp_f32(img, H, W, py, px),
                                  hr._gather_mix(img.reshape(-1), idx, wts))
    img3 = rng.integers(0, 256, (H, W, 3), np.uint8)
    mix = hr._gather_mix(img3.reshape(H * W, 3).astype(np.float32), idx, wts)
    np.testing.assert_array_equal(
        hr._warp_u8(img3, H, W, py, px),
        np.clip(np.floor(mix), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_pipeline_host_backend_equals_jax(name, rooms):
    pano = rooms[name][0]
    got = pano_edge_detection(pano)
    want = j_ped(pano)
    for key in ("vp", "lines", "score", "pano_edge"):
        np.testing.assert_array_equal(got[key], want[key])


# --- the torch device backend (on the CPU) against JAX's device backend ---

def test_backend_resolution(monkeypatch):
    assert views.preprocess_backend() == "host"
    assert views.preprocess_backend("device") == "device"
    monkeypatch.setenv("HORIZONNET_PREPROCESS_BACKEND", "device")
    assert views.preprocess_backend() == "device"
    with pytest.raises(ValueError):
        views.preprocess_backend("tpu")


def test_cut_views_device_matches_jax_device():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 128, 3), np.uint8)
    g = views.cut_views_gray(img, size=48, backend="device", device="cpu")
    gj = np.asarray(jviews.cut_views_gray(img, size=48, backend="device"))
    assert g.dtype == np.float16 and g.shape == (26, 48, 48)
    assert np.abs(g.astype(np.float32) - gj.astype(np.float32)).max() < 0.15
    assert np.abs(g.astype(np.float32) - jviews.cut_views_gray(
        img, size=48, backend="host")).max() < 0.15
    img = rng.uniform(0, 255, (64, 128, 3))
    v = views.cut_views(img, size=48, backend="device", device="cpu")
    vj = np.asarray(jviews.cut_views(img, size=48, backend="device"))
    assert v.shape == vj.shape == (26, 48, 48, 3)
    assert np.abs(v - vj).max() < 0.2
    np.testing.assert_allclose(views.rgb_to_gray(v), (v * [0.299, 0.587,
                                                           0.114]).sum(-1),
                               rtol=1e-5)


def test_rotate_device_matches_jax_device():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (64, 128, 3), np.uint8)
    R = yaw_tilt(33.0, 16.5)
    f = rotate.rotate_panorama(img.astype(np.float32), R=R,
                               backend="device", device="cpu")
    fj = np.asarray(jrotate.rotate_panorama(img.astype(np.float32), R=R,
                                            backend="device"))
    assert f.dtype == np.float32 and f.shape == img.shape
    assert np.abs(f - fj).mean() < 0.05
    u = rotate.rotate_panorama_uint8(img, R=R, backend="device", device="cpu")
    uj = jrotate.rotate_panorama_uint8(img, R=R, backend="device")
    assert u.dtype == np.uint8 and u.shape == img.shape
    assert (u.astype(int) != uj.astype(int)).mean() < 0.01


def test_rotate_device_uint8_matches_float_path():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 128, 6), np.uint8)
    R = yaw_tilt(np.degrees(0.4), 0)
    f = rotate.rotate_panorama(img.astype(np.float32) / 255.0, R=R,
                               backend="device", device="cpu")
    ref = (np.clip(f, 0, 1) * 255).astype(np.uint8)
    u8 = rotate.rotate_panorama_uint8(img, R=R, backend="device",
                                      device="cpu")
    diff = np.abs(u8.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def test_rotate_device_identity_roll_and_inverse():
    rng = np.random.default_rng(10)
    kw = dict(backend="device", device="cpu")
    img = rng.uniform(0, 1, (32, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(rotate.rotate_panorama(img, R=np.eye(3), **kw),
                               img, atol=5e-4)
    out = rotate.rotate_panorama(img, R=yaw_tilt(360 * 16 / 64, 0), **kw)
    err = min(np.abs(out - np.roll(img, s, axis=1)).mean() for s in (16, -16))
    assert err < 5e-4
    ys, xs = np.meshgrid(np.linspace(0, 4, 64), np.linspace(0, 8, 128),
                         indexing="ij")
    smooth = ((np.stack([np.sin(xs) * np.cos(ys), np.cos(xs), np.sin(ys)],
                        -1) + 1) / 2).astype(np.float32)
    R = yaw_tilt(20, 0)
    back = rotate.rotate_panorama(rotate.rotate_panorama(smooth, R=R, **kw),
                                  R=np.linalg.inv(R), **kw)
    assert np.abs(back - smooth).mean() < 0.01


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_pipeline_device_backend_matches_jax_device(name, rooms,
                                                   monkeypatch):
    pano = rooms[name][0]
    got = pano_edge_detection(pano, want_pano_edge=False, backend="device",
                              device="cpu")
    monkeypatch.setenv("HORIZONNET_PREPROCESS_BACKEND", "device")
    want = j_ped(pano, want_pano_edge=False)
    assert max(vp_rows_deg(got["vp"], want["vp"])) < 0.01


@pytest.mark.parametrize("backend", ["host", "device"])
def test_known_rotation_recovered(backend, rooms):
    vp0 = pano_edge_detection(rooms["room"][0],
                              want_pano_edge=False)["vp"][:3]
    for name in ("yaw20_tilt8", "yaw-35_tilt5"):
        pano, R = rooms[name]
        vp = pano_edge_detection(pano, want_pano_edge=False, backend=backend,
                                 device="cpu")["vp"][:3]
        vert, *horiz = vp_rows_deg(vp, vp0 @ R.T)
        assert vert < 0.1 and max(horiz) < 1.5, (name, vert, horiz)


# --- the resample and the PNG writer --------------------------------------

@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3)])
def test_unbatched_resample_equals_batched(shape):
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    cy = torch.from_numpy(rng.uniform(-12, 20, (4, 5, 6)).astype(np.float32))
    cx = torch.from_numpy(rng.uniform(-12, 20, (4, 5, 6)).astype(np.float32))
    got = bilinear_wrap_sample_one(img, cy, cx)
    img4 = img.reshape(1, *shape[:2], -1)
    want = bilinear_wrap_sample(img4, cy[None], cx[None])[0]
    assert got.shape == cy.shape + shape[2:]
    torch.testing.assert_close(got, want.reshape(got.shape), rtol=0, atol=0)


def test_write_png_level1_roundtrip(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (17, 29, 3), np.uint8)
    write_png(str(tmp_path / "a.png"), img, level=1)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
