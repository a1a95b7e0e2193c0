"""The port's preprocess and vp_debug CLIs against the JAX package's, on the
CPU.

Raw panos (val_room.png rotated by a known R, tests/test_torch_preprocess)
are written to tmp_path; the port's CLI with ``--device cpu`` (the host
backend, the JAX CLI's default) must write what JAX's CLI writes on the
same files: ``_VP.txt`` equal as text, the aligned RGB and line PNGs equal
as decoded arrays, with and without --rgbonly. ``--device cuda`` without a
CUDA device raises.
"""

import os

import numpy as np
import pytest
import torch

from horizonnet_tpu.cli import preprocess as jax_preprocess
from horizonnet_tpu.cli import vp_debug as jax_vp_debug
from horizonnet_tpu_torch.cli import preprocess, vp_debug
from horizonnet_tpu_torch.utils.image import read_png, write_png
from tests.test_torch_preprocess import raw_rooms


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    for name, (pano, _) in raw_rooms().items():
        write_png(str(d / f"{name}.png"), pano)
    return d


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    # the JAX CLIs turn on XLA's disk cache under the home directory; these
    # tests compile nothing worth caching
    monkeypatch.setattr("horizonnet_tpu.utils.enable_compilation_cache",
                        lambda: None)
    monkeypatch.delenv("HORIZONNET_PREPROCESS_BACKEND", raising=False)


def _outputs(out):
    return sorted(os.listdir(out))


@pytest.mark.parametrize("rgbonly", [False, True])
def test_preprocess_cli_equals_jax(raw_dir, tmp_path, rgbonly):
    flags = ["--img_glob", str(raw_dir / "*.png"), "--num_workers", "2"]
    flags += ["--rgbonly"] if rgbonly else []
    assert preprocess.main(flags + ["--output_dir", str(tmp_path / "port"),
                                    "--device", "cpu"]) == 0
    assert jax_preprocess.main(flags + ["--output_dir",
                                        str(tmp_path / "jax")]) == 0
    names = _outputs(tmp_path / "port")
    assert names == _outputs(tmp_path / "jax")
    assert len(names) == (3 if rgbonly else 9)
    for name in names:
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".txt"):
            assert got.read_text() == want.read_text(), name
            continue
        img = read_png(str(got))
        assert img.shape == (512, 1024, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, read_png(str(want)), err_msg=name)


def test_preprocess_cli_cuda_without_cuda_raises(raw_dir, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess.main(["--img_glob", str(raw_dir / "room.png"),
                         "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        vp_debug.main(["--i", str(raw_dir / "room.png"), "--o_prefix",
                       str(tmp_path / "x")])


@pytest.mark.parametrize("device,backend", [("cpu", None), ("cuda", "host"),
                                            ("cpu", "device")])
def test_warp_backend_choice(device, backend, monkeypatch):
    if backend:
        monkeypatch.setenv("HORIZONNET_PREPROCESS_BACKEND", backend)
    want = backend or ("device" if device == "cuda" else "host")
    assert preprocess.warp_backend(torch.device(device)) == want
    monkeypatch.setenv("HORIZONNET_PREPROCESS_BACKEND", "gpu")
    with pytest.raises(ValueError):
        preprocess.warp_backend(torch.device(device))


def test_vp_debug_equals_jax(raw_dir, tmp_path, capsys):
    pano = str(raw_dir / "yaw20_tilt8.png")
    assert vp_debug.main(["--i", pano, "--o_prefix", str(tmp_path / "port"),
                          "--device", "cpu"]) == 0
    port_vp = capsys.readouterr().out.split("Vanishing point:")[1]
    assert jax_vp_debug.main(["--i", pano, "--o_prefix",
                              str(tmp_path / "jax")]) == 0
    assert port_vp == capsys.readouterr().out.split("Vanishing point:")[1]
    for kind in ("edg", "img", "one"):
        img = read_png(str(tmp_path / f"port_{kind}.png"))
        assert img.shape == (512, 1024, 3)
        np.testing.assert_array_equal(
            img, read_png(str(tmp_path / f"jax_{kind}.png")), err_msg=kind)
