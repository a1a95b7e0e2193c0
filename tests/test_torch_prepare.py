"""The port's dataset-preparation CLIs against the JAX package, and the
PNG-only paths of the new CLIs on a host without Pillow or imageio.

On tests/test_prepare_scripts.py's synthetic Structured3D zip and ZInD
tree both CLIs write the same trees: the same files and symlinks, the same
text, the same JPEG bytes (both encode with Pillow's settings) and the
same PNG pixels (JAX writes them with imageio, the port with
utils/image.py::write_png, so those file bytes differ).
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from horizonnet_tpu.cli import prepare_structured3d as jax_st3d
from horizonnet_tpu.cli import prepare_zind as jax_zind
from horizonnet_tpu_torch.cli import prepare_structured3d as st3d
from horizonnet_tpu_torch.cli import prepare_zind as zind
from horizonnet_tpu_torch.utils.image import read_png, write_png
from tests.test_prepare_scripts import _make_st3d_zip, _make_zind_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root):
    """{relative path: ("link", target relative to ``root``'s parent) or
    ("file", decoded pixels or bytes)} of every entry under ``root``."""
    out = {}
    top = os.path.dirname(root)
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            path = os.path.join(d, name)
            key = os.path.relpath(path, root)
            if os.path.islink(path):
                target = os.readlink(path)
                out[key] = ("link", os.path.relpath(target, top).split(
                    os.sep, 1)[1])
            elif os.path.isfile(path):
                out[key] = ("file", read_png(path).tobytes()
                            if name.endswith(".png")
                            else open(path, "rb").read())
            else:
                out[key] = ("dir", None)
    return out


def test_structured3d_trees_equal_jax(tmp_path):
    zip_path = str(_make_st3d_zip(str(tmp_path / "st3d.zip")))
    trees = []
    for main, tag in ((st3d.main, "p"), (jax_st3d.main, "j")):
        root = tmp_path / tag
        raw = str(root / "raw")
        assert main(["extract", "--zippath", zip_path, "--outdir", raw]) == 0
        assert main(["prepare", "--in_root", raw,
                     *[a for s in ("train", "valid", "test")
                       for a in (f"--out_{s}_root", str(root / s))]]) == 0
        assert main(["gen_txt", "--root", raw,
                     *[a for s in ("train", "valid", "test")
                       for a in (f"--{s}_txt", str(root / f"{s}.txt"))]]) == 0
        trees.append(_tree(str(root)))
    assert trees[0] == trees[1]
    assert trees[0]["raw/scene_00000/rgb/0_rgb_rawlight.png"][0] == "file"
    assert len(trees[0]) == 34


def test_structured3d_names_a_png_it_cannot_read(tmp_path):
    """A 16-bit pano: the reader refuses it, naming the zip member."""
    zip_path = str(tmp_path / "st3d.zip")
    body = b"\x89PNG\r\n\x1a\n" + (13).to_bytes(4, "big") + b"IHDR" + \
        (16).to_bytes(4, "big") + (8).to_bytes(4, "big") + \
        bytes([16, 2, 0, 0, 0]) + b"\0" * 4
    base = "Structured3D/scene_00000/2D_rendering/7/panorama"
    with zipfile.ZipFile(zip_path, "w") as z:
        z.writestr(f"{base}/camera_xyz.txt", "0 0 1.6\n")
        z.writestr(f"{base}/full/rgb_rawlight.png", body)
    with pytest.raises(ValueError, match=f"{base}/full/rgb_rawlight.png"):
        st3d.main(["extract", "--zippath", zip_path, "--outdir",
                   str(tmp_path / "raw")])


@pytest.mark.parametrize("workers,flags", [("1", []),
                                           ("2", ["--is_primary", "-1"])])
def test_zind_trees_equal_jax(tmp_path, workers, flags):
    indir = tmp_path / "zind"
    indir.mkdir()
    scene_id, _ = _make_zind_scene(indir)
    partition = tmp_path / "partition.json"
    partition.write_text(json.dumps({"train": [scene_id], "val": []}))
    trees = []
    for main, tag in ((zind.main, "p"), (jax_zind.main, "j")):
        out = tmp_path / tag / "out"
        assert main(["--partition", str(partition), "--indir", str(indir),
                     "--outdir", str(out), "--width", "256",
                     "--num_workers", workers, *flags]) == 0
        trees.append(_tree(str(out)))
    assert trees[0] == trees[1]
    n_img = sum(k.startswith("train/img/") for k in trees[0])
    assert n_img == (2 if flags else 1)


_NO_PILLOW = """
import sys
sys.modules["PIL"] = None
sys.modules["imageio"] = None
argv = sys.argv[1:]
from horizonnet_tpu_torch.cli import (dataset_vis, eval_cuboid, eval_general,
                                      layout_viewer, prepare_structured3d)
root = argv[0]
assert prepare_structured3d.main(["extract", "--zippath", root + "/st3d.zip",
                                  "--outdir", root + "/raw"]) == 0
assert layout_viewer.main(["--img", argv[1], "--layout",
                           root + "/layout.json", "--html", root + "/v.html",
                           "--vis_out", root + "/v.png"]) == 0
assert dataset_vis.main(["--root_dir", root + "/rooms", "--out_dir",
                         root + "/vis", "--device", "cpu", "--flip",
                         "--gamma"]) == 0
for main in (eval_cuboid.main, eval_general.main):
    assert main(["--dt_glob", root + "/dt/*.json", "--gt_glob",
                 root + "/gt/*.txt"]) == 0
assert "PIL" not in sys.modules or sys.modules["PIL"] is None
print("NO_PILLOW_OK")
"""


def test_png_paths_run_without_pillow(tmp_path):
    """prepare_structured3d extract, layout_viewer (--html, --vis_out),
    dataset_vis with augmentation and the eval CLIs, in a process where
    importing PIL or imageio fails."""
    from horizonnet_tpu_torch.data.synth import synth_room

    _make_st3d_zip(str(tmp_path / "st3d.zip"))
    want = np.load(os.path.join(REPO, "tests", "fixtures", "golden",
                                "golden_outputs.npz"))
    for d in ("rooms/img", "rooms/label_cor", "dt", "gt"):
        os.makedirs(tmp_path / d)
    dt = {"z0": 50.0, "z1": float(want["cuboid_z1"]),
          "uv": want["cuboid_uv"].tolist()}
    (tmp_path / "layout.json").write_text(json.dumps(dt))
    (tmp_path / "dt" / "room0.json").write_text(json.dumps(dt))
    img, cor = synth_room(np.random.default_rng(0), 128, 256, 0.0)
    write_png(str(tmp_path / "rooms" / "img" / "room0.png"), img)
    np.savetxt(tmp_path / "rooms" / "label_cor" / "room0.txt", cor,
               fmt="%.4f")
    np.savetxt(tmp_path / "gt" / "room0.txt", cor * [4, 4], fmt="%.4f")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PILLOW, str(tmp_path),
         os.path.join(REPO, "tests", "fixtures", "golden", "val_room.png")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_PILLOW_OK" in proc.stdout
    assert read_png(str(tmp_path / "v.png")).shape == (480, 2560, 3)
    assert read_png(str(tmp_path / "vis" / "room0.png")).shape == \
        (33 + 128, 256, 3)
    assert read_png(str(tmp_path / "raw" / "scene_00000" / "rgb" /
                        "0_rgb_rawlight.png")).shape == (8, 16, 3)
    assert "3DIoU" in proc.stdout
