"""The port's viewer (mesh, preview, HTML), the layout_viewer CLI and the
dataset_vis CLI against the JAX package.

The viewer is host numpy on both sides: the mesh, wireframe and
triangulation arrays are equal, the PLY and HTML files are byte-identical
and the preview PNG pixel-identical (the JAX CLI writes it with Pillow,
the port with utils/image.py::write_png, so the file bytes differ).
dataset_vis draws its augmentation from an unseeded
``np.random.default_rng()``, which the tests seed in both CLIs: without
augmentation the strips are pixel-identical; with it (the port's warp on
the CPU device) the labels are exact and the warped pano is within the
2e-4 of tests/test_torch_data.py, so a strip pixel is within one of 255
levels (a value at a rounding edge flips one level).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from horizonnet_tpu.cli import dataset_vis as jax_dataset_vis
from horizonnet_tpu.cli import layout_viewer as jax_layout_viewer
from horizonnet_tpu.viewer import html as jax_html
from horizonnet_tpu.viewer import mesh as jax_mesh
from horizonnet_tpu.viewer import render as jax_render
from horizonnet_tpu_torch.cli import dataset_vis, layout_viewer
from horizonnet_tpu_torch.data.synth import synth_room
from horizonnet_tpu_torch.utils.image import read_png, write_png
from horizonnet_tpu_torch.viewer import html, mesh, render

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _golden_layout(H, W):
    """The golden cuboid and general fits in pixels of an H x W pano."""
    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    return [(want[f"{m}_uv"] * [W, H]).astype(np.float32)
            for m in ("cuboid", "general")]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("ignore", [(), ("floor",), ("ceiling", "wall")])
def test_mesh_arrays_equal_jax(mode, ignore):
    H, W = 64, 128
    cor = _golden_layout(H, W)[mode]
    img = np.random.default_rng(mode).uniform(0, 1, (H, W, 3))
    kw = {f"ignore_{k}": True for k in ignore}
    for got, want in zip(mesh.layout_to_points(cor, img, **kw),
                         jax_mesh.layout_to_points(cor, img, **kw)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(mesh.layout_to_mesh(cor, img, **kw),
                         jax_mesh.layout_to_mesh(cor, img, **kw)):
        np.testing.assert_array_equal(got, want)
    mask = mesh.layout_to_points(cor, img, **kw)[2]
    np.testing.assert_array_equal(mesh.grid_triangulate(mask),
                                  jax_mesh.grid_triangulate(mask))
    for got, want in zip(mesh.corner_wireframe(cor, H, W),
                         jax_mesh.corner_wireframe(cor, H, W)):
        np.testing.assert_array_equal(got, want)


def test_ply_html_and_preview_equal_jax(tmp_path):
    H, W = 64, 128
    cor = _golden_layout(H, W)[1]
    img = np.random.default_rng(3).uniform(0, 1, (H, W, 3))
    xyz, rgb, faces = mesh.layout_to_mesh(cor, img)
    wf = mesh.corner_wireframe(cor, H, W)[:2]
    for pkg, tag in ((mesh, "p"), (jax_mesh, "j")):
        pkg.write_ply(str(tmp_path / f"{tag}.ply"), xyz, rgb, faces)
    for pkg, tag in ((html, "p"), (jax_html, "j")):
        assert pkg.write_html_viewer(str(tmp_path / f"{tag}.html"), xyz, rgb,
                                     faces, wireframe=wf) == (len(xyz),
                                                              len(faces))
    for ext in ("ply", "html"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    np.testing.assert_array_equal(
        render.render_layout_views(xyz, rgb, 48, 64, n_views=3),
        jax_render.render_layout_views(xyz, rgb, 48, 64, n_views=3))


def test_layout_viewer_cli_equals_jax(tmp_path):
    """One full-size run of each CLI (it always works at 1024x512) on the
    golden pano and its cuboid fit as an inference JSON: the HTML viewer
    and the preview. The PLY writer is held byte for byte above, on a
    smaller mesh: at full size it takes 5 s a run."""
    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    layout = tmp_path / "val_room.json"
    layout.write_text(json.dumps({"z0": 50.0,
                                  "z1": float(want["cuboid_z1"]),
                                  "uv": want["cuboid_uv"].tolist()}))
    outs = {}
    for pkg, tag in ((layout_viewer, "p"), (jax_layout_viewer, "j")):
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            assert pkg.main(["--img", os.path.join(FIXDIR, "val_room.png"),
                             "--layout", str(layout),
                             "--html", str(tmp_path / f"{tag}.html"),
                             "--vis_out", str(tmp_path / f"{tag}.png")]) == 0
        outs[tag] = stdout.getvalue().replace(f"/{tag}.", "/X.")
    assert outs["p"] == outs["j"]
    assert (tmp_path / "p.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()
    preview = read_png(str(tmp_path / "p.png"))
    assert preview.shape == (480, 2560, 3)
    np.testing.assert_array_equal(preview, read_png(str(tmp_path / "j.png")))


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """Two synthetic rooms at 128x256 as a PNG dataset."""
    root = tmp_path_factory.mktemp("rooms")
    os.makedirs(root / "img")
    os.makedirs(root / "label_cor")
    for i in range(2):
        img, cor = synth_room(np.random.default_rng(i), 128, 256, 0.5 * i)
        write_png(str(root / "img" / f"room{i}.png"), img)
        np.savetxt(root / "label_cor" / f"room{i}.txt", cor, fmt="%.4f")
    return str(root)


def _dataset_vis(main, argv, seed, monkeypatch):
    """``main(argv)`` with np.random.default_rng() seeded by ``seed``."""
    draw = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a: draw(seed if not a else a[0]))
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0
    monkeypatch.setattr(np.random, "default_rng", draw)


@pytest.mark.parametrize("aug", [[], ["--flip", "--rotate", "--gamma",
                                      "--stretch"]])
def test_dataset_vis_equals_jax(rooms, tmp_path, monkeypatch, aug):
    for main, out, extra in ((dataset_vis.main, "p", ["--device", "cpu"]),
                             (jax_dataset_vis.main, "j", [])):
        _dataset_vis(main, ["--root_dir", rooms, "--ith", "-1", "--out_dir",
                            str(tmp_path / out), *aug, *extra], 5,
                     monkeypatch)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["room0.png", "room1.png"]
    assert sorted(os.listdir(tmp_path / "p")) == names
    for name in names:
        got = read_png(str(tmp_path / "p" / name)).astype(int)
        want = read_png(str(tmp_path / "j" / name)).astype(int)
        assert got.shape == want.shape == (33 + 128, 256, 3)
        if aug:
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)


def test_dataset_vis_refuses_a_missing_cuda_device(rooms, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataset_vis.main(["--root_dir", rooms, "--out_dir",
                          str(tmp_path), "--flip"])
