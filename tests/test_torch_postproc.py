"""The port's wire decode and fused cuboid fit against the JAX package."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from horizonnet_tpu.geometry.equirect import mean_percentile as jax_mp
from horizonnet_tpu.ops import dct as jax_dct
from horizonnet_tpu.ops.filters import circular_max_filter_1d as jax_maxf
from horizonnet_tpu.postproc import device as jax_pp
from horizonnet_tpu_torch.geometry.equirect import mean_percentile
from horizonnet_tpu_torch.ops import dct
from horizonnet_tpu_torch.ops.filters import circular_max_filter_1d
from horizonnet_tpu_torch.postproc import device as pp
from horizonnet_tpu_torch.postproc import unpack_cuboid_outputs
from horizonnet_tpu_torch.utils.image import read_png

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")
H, W = 512, 1024


@pytest.fixture(scope="module")
def rooms():
    img = read_png(os.path.join(FIXDIR, "val_room.png"))
    return np.stack([img, np.roll(img, 333, axis=1)])


@pytest.mark.parametrize("fmt", ["dct", "dct4"])
def test_wire_decode_matches_jax(fmt, rooms):
    pack = getattr(dct, "pack_" + fmt)
    unpack = getattr(dct, f"unpack_{fmt}_to_rgb")
    wire = pack(rooms)
    np.testing.assert_array_equal(wire, getattr(jax_dct, "pack_" + fmt)(rooms))
    want = np.asarray(getattr(jax_dct, f"unpack_{fmt}_to_rgb")(
        jnp.asarray(wire)))
    got = unpack(torch.from_numpy(wire))
    assert got.dtype == torch.float32 and got.shape == (2, H, W, 3)
    # same f32 synthesis matmul on both sides
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # lossy but close to the source pano
    assert np.abs(got.numpy() - rooms / 255.0).mean() < 0.02
    with pytest.raises(ValueError, match="wire shape"):
        unpack(torch.from_numpy(wire[:, :-1]))


def test_dct4_nibble_sign_extension_matches_jax():
    """Every int8 byte value through the dct4 nibble unpack of a 16x16
    pano (4 luma tiles of 9 bytes, one 4-byte tile per chroma plane)."""
    m_y, m_c = 15, 6
    n = dct.dct4_wire_shape(1, 16, 16, m_y, m_c)[1]
    shift_bytes = [9 * t + 1 for t in range(4)] + [37, 41]
    rng = np.random.default_rng(0)
    sweep = np.arange(-128, 128).astype(np.int8)
    for k in range(8):
        wire = np.roll(sweep, 44 * k)[:n].reshape(1, n).copy()
        # the encoder's shifts are 0..7 (the low nibble of each tile's
        # first nibble byte)
        for i in shift_bytes:
            b = int(wire[0, i]) & 0xF0 | int(rng.integers(0, 8))
            wire[0, i] = np.int8(b - 256 if b > 127 else b)
        want = np.asarray(jax_dct.unpack_dct4_to_rgb(
            jnp.asarray(wire), 16, 16, m_y, m_c))
        got = dct.unpack_dct4_to_rgb(torch.from_numpy(wire), 16, 16, m_y, m_c)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _raw_outputs(seed, B=4):
    rng = np.random.default_rng(seed)
    bon = np.stack([rng.uniform(-0.9, -0.2, (B, W)),
                    rng.uniform(0.2, 0.9, (B, W))], 1).astype(np.float32)
    cor = rng.uniform(0, 1, (B, W)).astype(np.float32)
    return bon, cor


def _cuboid_parity(bon, cor):
    cj, zj = jax_pp.postprocess_cuboid_batch(jnp.asarray(bon),
                                             jnp.asarray(cor), H, W)
    ct, zt = pp.postprocess_cuboid_batch(torch.from_numpy(bon),
                                         torch.from_numpy(cor), H, W)
    assert ct.shape == cj.shape and zt.shape == zj.shape
    # both f32; sums taken in other orders: 1e-4 of the width (0.1 px)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5)
    packed = pp.pack_cuboid_outputs((ct, zt))
    cid, z1 = unpack_cuboid_outputs(packed)
    np.testing.assert_array_equal(cid, ct.numpy())
    np.testing.assert_array_equal(z1, zt.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuboid_fit_matches_jax_random(seed):
    _cuboid_parity(*_raw_outputs(seed))


def test_cuboid_fit_matches_jax_on_plateaus_and_degenerate_signals():
    bon, cor = _raw_outputs(3)
    cor[0] = 0.0
    cor[0, 100:140] = 0.7          # two plateaus: ties broken by column
    cor[0, 600:640] = 0.7
    cor[1] = 0.0                   # no peak at all: evenly spaced fallback
    cor[2] = 0.0
    cor[2, [10, 500]] = 0.9        # two peaks: fallback fills the rest
    cor[3] = 0.5                   # one flat plateau over the whole row
    _cuboid_parity(bon, cor)
    locs = pp.find_4_peaks(torch.from_numpy(cor), 26).numpy()
    np.testing.assert_array_equal(
        locs, np.asarray(jax_pp.find_4_peaks(jnp.asarray(cor), 26)))
    np.testing.assert_array_equal(locs[0], [100, 101, 102, 103])
    np.testing.assert_array_equal(locs[1], [0, 256, 512, 768])


def test_cuboid_fit_matches_jax_on_golden_outputs():
    """Raw outputs of the committed golden checkpoint on val_room (and a
    rolled copy), from the port's f32 forward."""
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model

    model, sd = load_trained_model(os.path.join(
        FIXDIR, "resnet18_rnn_synth.ckpt"), device="cpu")
    img = read_png(os.path.join(FIXDIR, "val_room.png"))
    x = np.stack([img, np.roll(img, 200, axis=1)]).astype(np.float32) / 255
    bon, cor = InferenceEngine(model, sd, batch_size=2, device="cpu")(x)
    _cuboid_parity(bon.numpy(), cor[:, 0].numpy())


def test_vote_sorted_matches_jax():
    rng = np.random.default_rng(5)
    rows, Wv = 64, 40
    m = rng.integers(0, Wv + 1, rows)
    m[:3] = [0, 1, Wv]
    vals = np.round(rng.normal(0, 3, (rows, Wv)), 1).astype(np.float32)
    vals[np.arange(Wv)[None] >= m[:, None]] = np.inf
    svals = np.sort(vals, -1)
    tol = rng.uniform(0.2, 3.0, rows).astype(np.float32)
    tol[3] = 100.0                 # m < tol: median fallback
    want = jax_pp.vote_sorted(jnp.asarray(svals), jnp.asarray(m),
                              jnp.asarray(tol))
    got = pp.vote_sorted(torch.from_numpy(svals), torch.from_numpy(m),
                         torch.from_numpy(tol))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("size", [1, 2, 5, 26])
def test_circular_max_filter_matches_jax(size):
    x = np.random.default_rng(size).normal(size=(3, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        circular_max_filter_1d(torch.from_numpy(x), size).numpy(),
        np.asarray(jax_maxf(jnp.asarray(x), size)))


def test_mean_percentile_matches_jax():
    """numpy's linear percentile (jnp.percentile) vs torch.quantile,
    including ties and an odd length."""
    rng = np.random.default_rng(8)
    x = np.round(rng.normal(size=(6, 1023)), 2).astype(np.float32)
    np.testing.assert_allclose(
        mean_percentile(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jax_mp(jnp.asarray(x), axis=-1)), rtol=1e-6)


@pytest.mark.parametrize("N,min_v", [(None, 0.05), (4, 0.0)])
def test_find_peaks_np_copy_matches_jax_package(N, min_v):
    from horizonnet_tpu.ops.filters import find_peaks_np as jax_fp
    from horizonnet_tpu_torch.ops.filters import find_peaks_np

    sig = np.random.default_rng(9).uniform(0, 1, 1024)
    got, want = find_peaks_np(sig, 26, min_v, N), jax_fp(sig, 26, min_v, N)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
