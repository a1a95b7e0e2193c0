"""The port's cuboid evals, their polytope and the eval CLIs against JAX.

Everything here is host numpy on both sides (float64 geometry, the
float32 parsing of the CLIs), on the same seeded inputs: the bar is exact
equality, and the eval CLIs' stdout is identical letter for letter. One
case holds the polytope volume to scipy's Qhull within 1e-9 relative (two
exact constructions summed in another order).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from horizonnet_tpu.cli import eval_cuboid as jax_eval_cuboid_cli
from horizonnet_tpu.cli import eval_general as jax_eval_general_cli
from horizonnet_tpu.evals import cuboid as jax_cuboid
from horizonnet_tpu.geometry import polytope as jax_polytope
from horizonnet_tpu_torch.cli import eval_cuboid as eval_cuboid_cli
from horizonnet_tpu_torch.cli import eval_general as eval_general_cli
from horizonnet_tpu_torch.evals import cuboid
from horizonnet_tpu_torch.geometry import polytope
from tests.test_evals import _synthetic_cuboid

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _rooms(seed):
    """Two camera-centred cuboid rooms of random size and offset."""
    rng = np.random.default_rng(seed)
    return [_synthetic_cuboid(dx=rng.uniform(-0.8, 0.8),
                              dy=rng.uniform(-0.6, 0.6),
                              w=rng.uniform(1.5, 4.0),
                              d=rng.uniform(1.2, 3.0)) for _ in range(2)]


def _random_halfspaces(rng, n):
    """n halfspaces [n | b] with the origin strictly inside (b < 0)."""
    normals = rng.normal(size=(n, 3))
    return np.concatenate([normals, -rng.uniform(0.5, 3.0, (n, 1))], 1)


@pytest.mark.parametrize("seed", range(6))
def test_polytope_equals_jax(seed):
    rng = np.random.default_rng(seed)
    hs = _random_halfspaces(rng, 6 + 3 * seed)
    got, want = polytope.clip_polytope(hs), jax_polytope.clip_polytope(hs)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert polytope.polytope_volume(got) == jax_polytope.polytope_volume(want)
    assert polytope.halfspace_intersection_volume(hs, bound=50.0) == \
        jax_polytope.halfspace_intersection_volume(hs, bound=50.0)
    for a, b in zip(polytope._box_faces(2.0), jax_polytope._box_faces(2.0)):
        np.testing.assert_array_equal(a, b)

    # the layout construction of the cuboid eval, on two rooms' rings
    rings = [rng.normal(size=(4, 3)) for _ in range(2)]
    np.testing.assert_array_equal(polytope.layout_halfspaces(*rings),
                                  jax_polytope.layout_halfspaces(*rings))
    pa, pb, p = rng.normal(size=(3, 3))
    np.testing.assert_array_equal(polytope._tri2halfspace(pa, pb, p),
                                  jax_polytope._tri2halfspace(pa, pb, p))


def test_polytope_volume_vs_qhull():
    scipy_spatial = pytest.importorskip("scipy.spatial")
    hs = _random_halfspaces(np.random.default_rng(11), 24)
    hi = scipy_spatial.HalfspaceIntersection(hs, np.zeros(3))
    want = scipy_spatial.ConvexHull(hi.intersections).volume
    got = polytope.halfspace_intersection_volume(hs)
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_cuboid_metrics_equal_jax(seed):
    a, b = _rooms(seed)
    assert cuboid.eval_3diou(a[1::2], a[0::2], b[1::2], b[0::2]) == \
        jax_cuboid.eval_3diou(a[1::2], a[0::2], b[1::2], b[0::2])
    z1 = -1.6 * 50 / (1.1 + 0.1 * seed)
    losses = {"CE": [], "PE": [], "3DIoU": []}
    losses_j = {"CE": [], "PE": [], "3DIoU": []}
    cuboid.test_cuboid(a, 50.0, z1, b, 1024, 512, losses)
    jax_cuboid.test_cuboid(a, 50.0, z1, b, 1024, 512, losses_j)
    assert losses == losses_j
    assert 0 < losses["3DIoU"][0] < 100


def _write_eval_dirs(root, rolls):
    """The golden cuboid and general fits as inference JSONs, each pano
    rolled by a column shift, beside cuboid GT txts (a synthetic cuboid
    room rolled the same way) and the golden's own general GT."""
    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    gt_general = np.loadtxt(os.path.join(FIXDIR, "val_room_cor.txt"))
    gt_cuboid = _synthetic_cuboid(dx=0.3, dy=-0.2).astype(np.float64)
    for d in ("cuboid", "general", "gt_cuboid", "gt_general"):
        os.makedirs(os.path.join(root, d))

    def rolled(cor, r):
        cor = cor.copy()
        cor[:, 0] = (cor[:, 0] + r) % 1024
        pairs = cor.reshape(-1, 2, 2)
        return pairs[np.argsort(pairs[:, 0, 0])].reshape(-1, 2)

    for i, r in enumerate(rolls):
        for mode in ("cuboid", "general"):
            uv = rolled(want[f"{mode}_uv"] * [1024, 512], r) / [1024, 512]
            with open(os.path.join(root, mode, f"p{i}.json"), "w") as f:
                json.dump({"z0": 50.0, "z1": float(want[f"{mode}_z1"]),
                           "uv": uv.tolist()}, f)
        for name, gt in (("gt_cuboid", gt_cuboid), ("gt_general",
                                                    gt_general)):
            np.savetxt(os.path.join(root, name, f"p{i}.txt"), rolled(gt, r),
                       fmt="%.4f")


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("rolls", [[0], [0, 137, 511, 900]])
def test_eval_clis_print_what_jax_prints(tmp_path, rolls):
    _write_eval_dirs(str(tmp_path), rolls)
    for mode, gt, port, jax in (
            ("cuboid", "gt_cuboid", eval_cuboid_cli, jax_eval_cuboid_cli),
            ("general", "gt_general", eval_general_cli,
             jax_eval_general_cli),
            ("cuboid", "gt_general", eval_general_cli,
             jax_eval_general_cli)):
        argv = ["--dt_glob", str(tmp_path / mode / "*.json"),
                "--gt_glob", str(tmp_path / gt / "*.txt")]
        got = _stdout(port.main, argv)
        assert got == _stdout(jax.main, argv)
        assert "nan" not in got.lower(), got
    assert cuboid.prepare_gtdt_pairs(
        str(tmp_path / "gt_cuboid" / "*.txt"),
        str(tmp_path / "cuboid" / "*")) == jax_cuboid.prepare_gtdt_pairs(
        str(tmp_path / "gt_cuboid" / "*.txt"),
        str(tmp_path / "cuboid" / "*"))
