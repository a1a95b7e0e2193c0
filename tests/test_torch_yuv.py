"""The port's yuv420 wire (ops/yuv.py) against the JAX package."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from horizonnet_tpu.ops import yuv as jax_yuv
from horizonnet_tpu_torch.ops.yuv import pack_yuv420, unpack_yuv420_to_rgb
from horizonnet_tpu_torch.utils.image import read_png

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")


@pytest.fixture(scope="module")
def rooms():
    img = read_png(os.path.join(FIXDIR, "val_room.png"))[..., :3]
    noise = np.random.default_rng(0).integers(0, 256, img.shape, np.uint8)
    return np.stack([img, np.roll(img, 300, axis=1), noise])


def test_pack_is_byte_identical_to_jax(rooms):
    got = pack_yuv420(rooms)
    assert got.dtype == np.uint8 and got.shape == (3, 6, 256, 512)
    np.testing.assert_array_equal(got, jax_yuv.pack_yuv420(rooms))
    with pytest.raises(ValueError, match="even"):
        pack_yuv420(rooms[:, :, :-1])


def test_decode_matches_jax(rooms):
    """The same float32 inverse on both sides: within 1e-6."""
    wire = pack_yuv420(rooms)
    want = np.asarray(jax_yuv.unpack_yuv420_to_rgb(jnp.asarray(wire)))
    got = unpack_yuv420_to_rgb(torch.from_numpy(wire))
    assert got.dtype == torch.float32 and got.shape == rooms.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # lossy (chroma subsampling) but close to the source
    assert np.abs(got.numpy()[:2] - rooms[:2] / 255.0).mean() < 0.02


def test_engine_serves_the_yuv420_wire():
    """The golden checkpoint on val_room through the yuv420 wire and the
    cuboid fit: corners within 2 px of golden_outputs.npz (the JAX
    package's own yuv bar is sub-pixel against its RGB path)."""
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    img = read_png(os.path.join(FIXDIR, "val_room.png"))[None, ..., :3]
    model, sd = load_trained_model(os.path.join(
        FIXDIR, "resnet18_rnn_synth.ckpt"), device="cpu")
    eng = InferenceEngine(model, sd, postproc="cuboid",
                          input_format="yuv420", device="cpu")
    cid, z1 = unpack_cuboid_outputs(eng(pack_yuv420(img)))
    dpx = np.abs(cid[0] - want["cuboid_uv"]).max() * 512
    assert dpx < 2.0, f"yuv420 corners {dpx:.3f} px off golden"
    with pytest.raises(ValueError, match="batch shape"):
        eng(pack_yuv420(img)[:, :, :-1])
