"""The port's serving slice: engine, serve_stream and CLI, on the CPU.

The golden slice holds the committed checkpoint's raw outputs to the JAX
forward and its device-fit corners to golden_outputs.npz; the rest pins
the engine and serve_stream contracts the JAX package's tests pin.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.inference import (InferenceEngine, serve_stream,
                                            tta_forward)
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
from horizonnet_tpu_torch.utils.image import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")


@pytest.fixture(scope="module")
def golden():
    img = read_png(os.path.join(FIXDIR, "val_room.png"))
    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    return img[None].astype(np.float32) / 255.0, want


@pytest.fixture(scope="module")
def small():
    """resnet18_rnn at the reference height and a cut width."""
    return build_model("resnet18", True, device="cpu", seed=3)


def test_golden_slice_cpu_f32(golden):
    from horizonnet_tpu.inference import net_forward
    from horizonnet_tpu.train.checkpoint import load_trained_model as jax_load
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    x, want = golden
    model, sd = load_trained_model(CKPT, device="cpu")
    bon, cor = InferenceEngine(model, sd, device="cpu")(x)
    jax_model, variables = jax_load(CKPT)
    bon_j, cor_j = net_forward(jax_model, variables, x)
    # f32 on both sides (the 2e-4 bar of tests/test_full_parity.py)
    np.testing.assert_allclose(bon.numpy(), np.asarray(bon_j), atol=2e-4)
    np.testing.assert_allclose(cor.numpy(), np.asarray(cor_j), atol=2e-4)

    eng = InferenceEngine(model, sd, postproc="cuboid", device="cpu")
    packed = eng(x)
    assert packed.shape == (1, 17) and packed.dtype == torch.float32
    cid, z1 = unpack_cuboid_outputs(packed)
    dpx = np.abs(cid[0] - want["cuboid_uv"]).max() * 512
    assert dpx < 2.0, f"device cuboid corners off golden by {dpx:.2f}px"
    assert abs(float(z1[0]) - float(want["cuboid_z1"])) < 0.2


def test_serve_stream_contract_with_fake_engine():
    class FakeEngine:
        def put(self, x):
            return x

        def run(self, x):
            return ("out", x)

    eng = FakeEngine()
    for depth in (1, 3, 10):
        got = list(serve_stream(eng, iter(range(7)), depth=depth))
        assert got == [("out", k) for k in range(7)]
    assert list(serve_stream(eng, iter([]), depth=3)) == []

    def finish(outs):
        return ("fin",) + outs

    for depth in (1, 3, 10):
        for workers in (1, 2):
            got = list(serve_stream(eng, iter(range(7)), depth=depth,
                                    finish=finish, workers=workers))
            assert got == [("fin", "out", k) for k in range(7)]

    def boom(outs):
        raise RuntimeError("tail failed")

    with pytest.raises(RuntimeError, match="tail failed"):
        list(serve_stream(eng, iter(range(3)), depth=1, finish=boom))


def test_serve_stream_keeps_depth_in_flight():
    """At most depth + 1 batches are put before the first output leaves."""
    log = []

    class Engine:
        def put(self, x):
            log.append(("put", x))
            return x

        def run(self, x):
            return x

    for depth in (1, 3):
        log.clear()
        it = serve_stream(Engine(), iter(range(6)), depth=depth)
        assert next(it) == 0
        assert [e for e in log if e[0] == "put"] == [
            ("put", k) for k in range(depth + 1)]
        assert list(it) == list(range(1, 6))


def test_serve_stream_matches_direct_calls(small):
    rng = np.random.default_rng(3)
    eng = InferenceEngine(small, small.state_dict(), batch_size=1, W=128,
                          device="cpu")
    batches = [rng.uniform(0, 1, (1, 512, 128, 3)).astype(np.float32)
               for _ in range(3)]
    for depth in (2, 8):
        got = list(serve_stream(eng, iter(batches), depth=depth))
        assert len(got) == len(batches)
        for x, (bon_s, cor_s) in zip(batches, got):
            bon_d, cor_d = eng(x)
            torch.testing.assert_close(bon_s, bon_d, rtol=0, atol=0)
            torch.testing.assert_close(cor_s, cor_d, rtol=0, atol=0)


class _ColumnEcho(torch.nn.Module):
    """Outputs carry each column's content, so undoing a TTA copy must
    land every column back where it came from."""

    def forward(self, x):
        col = x.mean(dim=(1, 2))                      # [B, W]
        return torch.stack([col, -col], 1), col[:, None]


def test_tta_undo_reconstructs_exactly():
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, 3, 8, 128)).astype(np.float32))
    base = tta_forward(_ColumnEcho(), x)
    tta = tta_forward(_ColumnEcho(), x, flip=True, rotate=(0.25, 0.5))
    torch.testing.assert_close(tta[0], base[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(tta[1], base[1], rtol=0, atol=1e-6)
    assert torch.all((base[1] > 0) & (base[1] < 1))   # sigmoid applied


def test_engine_wire_formats(small):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (1, 512, 128, 3), dtype=np.uint8)
    engf = InferenceEngine(small, small.state_dict(), W=128, device="cpu")
    eng8 = InferenceEngine(small, small.state_dict(), W=128,
                           input_format="uint8", device="cpu")
    bf, cf = engf(img.astype(np.float32) / 255.0)
    b8, c8 = eng8(img)
    torch.testing.assert_close(b8, bf, rtol=0, atol=1e-5)
    torch.testing.assert_close(c8, cf, rtol=0, atol=1e-5)
    from horizonnet_tpu_torch.ops.dct import pack_dct, pack_dct4
    for fmt, pack in (("dct", pack_dct), ("dct4", pack_dct4)):
        eng = InferenceEngine(small, small.state_dict(), W=128,
                              input_format=fmt, postproc="cuboid",
                              device="cpu")
        cid, z1 = unpack_cuboid_outputs(eng(pack(img)))
        assert cid.shape == (1, 8, 2) and np.isfinite(cid).all()
    with pytest.raises(ValueError, match="batch shape"):
        eng8(img[:, :, :64])


def test_engine_refuses_modes_still_to_port(small):
    """General layouts and the yuv420 wire are served now (the packed
    candidate array and the [B, 6, H/2, W/2] planes); unknown modes are
    refused."""
    from horizonnet_tpu_torch.ops.yuv import pack_yuv420
    from horizonnet_tpu_torch.postproc import finish_general_batch

    sd = small.state_dict()
    eng = InferenceEngine(small, sd, W=128, postproc="general",
                          input_format="yuv420", device="cpu")
    img = np.random.default_rng(2).integers(0, 256, (1, 512, 128, 3),
                                            dtype=np.uint8)
    packed = eng(pack_yuv420(img))
    assert packed.shape == (1, 9 * 32 + 17) and packed.dtype == torch.float32
    (cor_id, z0, z1), = finish_general_batch(packed, 128, 512)
    assert cor_id.ndim == 2 and cor_id.shape[1] == 2 and len(cor_id) >= 8
    assert np.isfinite(cor_id).all() and z0 == 50.0 and np.isfinite(z1)
    with pytest.raises(ValueError, match="postproc"):
        InferenceEngine(small, sd, postproc="mesh", device="cpu")
    with pytest.raises(ValueError, match="input_format"):
        InferenceEngine(small, sd, input_format="jpeg", device="cpu")


def test_cuda_device_without_cuda_raises(small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(small, small.state_dict(), device="cuda")


def test_cli_golden(golden, tmp_path):
    from horizonnet_tpu_torch.cli.inference import main

    _, want = golden
    args = ["--pth", CKPT, "--img_glob", os.path.join(FIXDIR, "val_room.png"),
            "--output_dir", str(tmp_path), "--device_postproc",
            "--force_cuboid", "--device", "cpu"]
    assert main(args) == 0
    with open(tmp_path / "val_room.json") as f:
        got = json.load(f)
    assert got["z0"] == 50.0 and len(got["uv"]) == 8
    dpx = np.abs(np.asarray(got["uv"]) - want["cuboid_uv"]).max() * 512
    assert dpx < 2.0, f"CLI corners off golden by {dpx:.2f}px"
    assert abs(got["z1"] - float(want["cuboid_z1"])) < 0.2


@pytest.mark.parametrize("extra,match", [
    ([], "host postprocess"),
    (["--device_postproc", "--force_cuboid", "--visualize"],
     "host postprocess"),
    (["--device_postproc", "--profile_dir", "trace"], "item 11"),
    (["--device_postproc", "--force_cuboid", "--quant_int8"], "item 7"),
])
def test_cli_refuses_paths_still_to_port(extra, match, tmp_path):
    from horizonnet_tpu_torch.cli.inference import main

    with pytest.raises(NotImplementedError, match=match):
        main(["--pth", CKPT, "--img_glob", "x.png", "--output_dir",
              str(tmp_path), "--device", "cpu", *extra])


def test_port_never_imports_jax():
    """Every module of the port, plus a CPU forward, in a fresh process:
    neither jax, flax nor the JAX package gets imported."""
    code = """
import pkgutil, sys, importlib
import horizonnet_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import horizonnet_tpu_torch.ops.fused_block, horizonnet_tpu_torch.ops.yuv
import horizonnet_tpu_torch.postproc.manhattan
import horizonnet_tpu_torch.postproc.serving
import torch
from horizonnet_tpu_torch.inference import InferenceEngine
from horizonnet_tpu_torch.models import build_model
m = build_model("resnet18", True, device="cpu")
eng = InferenceEngine(m, m.state_dict(), W=64, postproc="cuboid",
                      input_format="uint8", device="cpu")
import numpy as np
out = eng(np.zeros((1, 512, 64, 3), np.uint8))
assert out.shape == (1, 17)
m = build_model("resnet50", True, device="cpu", fused_blocks="kernel")
eng = InferenceEngine(m, m.state_dict(), W=64, postproc="general",
                      input_format="uint8", device="cpu")
from horizonnet_tpu_torch.postproc import finish_general_batch
assert len(finish_general_batch(eng(np.zeros((1, 512, 64, 3), np.uint8)),
                                64, 512)) == 1
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "flax", "horizonnet_tpu"))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
