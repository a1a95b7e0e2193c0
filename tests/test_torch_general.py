"""The port's general-layout serving (device candidates + host greedy tail)
against the JAX package, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from horizonnet_tpu.ops.filters import find_peaks_device as jax_peaks
from horizonnet_tpu.postproc import device as jax_pp
from horizonnet_tpu.postproc import serving as jax_serving
from horizonnet_tpu_torch.ops.filters import find_peaks_device
from horizonnet_tpu_torch.postproc import device as pp
from horizonnet_tpu_torch.postproc import (finish_general_batch,
                                           pack_general_outputs,
                                           postprocess_general_batch,
                                           unpack_general_outputs)
from tests.test_postproc_device import _synthetic_general_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")
H, W = 512, 1024


def _rooms(seed, B):
    rng = np.random.default_rng(seed)
    raws = [_synthetic_general_raw(rng) for _ in range(B)]
    return (np.stack([r[0] for r in raws]).astype(np.float32),
            np.stack([r[1] for r in raws]).astype(np.float32))


def test_find_peaks_device_matches_jax_with_ties_and_overflow():
    """Plateaus (ties broken by column), more peaks than max_peaks (the
    highest win, equal values by column), no peak at all."""
    rng = np.random.default_rng(0)
    sig = np.round(rng.uniform(0, 1, (4, 200)), 1).astype(np.float32)
    sig[1] = 0.0
    sig[1, 20:30] = 0.7              # one plateau: every column is a max
    sig[1, 100:105] = 0.7
    sig[2] = 0.0                     # no peak above min_v
    sig[3] = np.tile([0.9, 0.1], 100)   # 100 equal peaks
    for r, max_peaks in ((5, 8), (3, 32)):
        want = jax_peaks(jnp.asarray(sig), r=r, min_v=0.05,
                         max_peaks=max_peaks)
        got = find_peaks_device(torch.from_numpy(sig), r=r, min_v=0.05,
                                max_peaks=max_peaks)
        assert got[0].dtype == torch.int32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    locs = got[0].numpy()
    np.testing.assert_array_equal(locs[3], np.arange(0, 64, 2))
    assert (locs[2] == -1).all()


def _segments(seed, B=3, n_seg=32):
    """Projected plan coordinates with ties, and segment ids that leave
    some of the n_seg segments empty."""
    rng = np.random.default_rng(seed)
    xy = np.round(rng.normal(500, 20, (B, 300, 2)), 0).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, 300), (B, 9), replace=False), -1)
    gpid = (np.arange(300)[None, :, None] >= cuts[:, None, :]).sum(-1)
    gpid[gpid == 9] = 0              # the wrapping last group merges into 0
    tol = rng.uniform(0.5, 8.0, B).astype(np.float32)
    return xy, gpid, tol


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_votes_grouped_matches_jax(seed):
    """The lexsort + merge engine against JAX's, and against the port's
    padded engine: both float32, sums in other orders (1e-4 relative)."""
    xy, gpid, tol = _segments(seed)
    want = jax_pp._segment_votes_grouped(jnp.asarray(xy), jnp.asarray(gpid),
                                         jnp.asarray(tol), 32)
    args = (torch.from_numpy(xy), torch.from_numpy(gpid),
            torch.from_numpy(tol), 32)
    got = pp._segment_votes_grouped(*args)
    padded = pp._segment_votes_padded(*args)
    for g, w, p in zip(got, want, padded):
        assert g.shape == (3, 32, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _general_parity(y_bon, y_cor):
    want = jax_pp.postprocess_general_batch(jnp.asarray(y_bon),
                                            jnp.asarray(y_cor), H, W)
    got = postprocess_general_batch(torch.from_numpy(y_bon),
                                    torch.from_numpy(y_cor), H, W)
    names = ("locs", "fit", "score", "l1", "mean", "z1", "cuboid")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # float32 on both sides: 1e-4 of the plan width (fit, mean, l1), of the
    # score, of z1, and of the normalized cuboid corners
    for n, g, w in zip(names[1:], got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=n)
    return got, want


def test_postprocess_general_batch_matches_jax_on_general_rooms():
    y_bon, y_cor = _rooms(3, 4)
    got, want = _general_parity(y_bon, y_cor)
    res = finish_general_batch(pack_general_outputs(got), W, H)
    res_j = jax_serving.finish_general_batch(
        jax_pp.pack_general_outputs(want), W, H)
    for (c, z0, z1), (cj, z0j, z1j) in zip(res, res_j):
        assert c.shape == cj.shape == (12, 2)    # all 6 corners found
        assert np.abs(c - cj).max() < 1.0 / 512   # within a pixel
        assert z0 == z0j and abs(z1 - z1j) < 1e-4


def test_postprocess_general_batch_matches_jax_on_random_outputs():
    """Outputs of no room at all: many peaks, non-alternating axes, the
    scalar greedy and its fallbacks."""
    rng = np.random.default_rng(6)
    y_bon = np.stack([rng.uniform(-0.9, -0.2, (3, W)),
                      rng.uniform(0.2, 0.9, (3, W))], 1).astype(np.float32)
    y_cor = rng.uniform(0, 1, (3, W)).astype(np.float32)
    _general_parity(y_bon, y_cor)


def test_pack_unpack_roundtrip():
    y_bon, y_cor = _rooms(7, 3)
    outs = postprocess_general_batch(torch.from_numpy(y_bon),
                                     torch.from_numpy(y_cor), H, W)
    packed = pack_general_outputs(outs)
    assert packed.shape == (3, 9 * 32 + 17) and packed.dtype == torch.float32
    unpacked = unpack_general_outputs(packed)
    assert unpacked[0].dtype == np.int32
    for a, b in zip(unpacked, outs):
        np.testing.assert_array_equal(a, b.numpy().astype(a.dtype))
    r_tuple = finish_general_batch(outs, W, H)
    r_packed = finish_general_batch(packed, W, H)
    for (ca, za0, za1), (cb, zb0, zb1) in zip(r_tuple, r_packed):
        assert np.array_equal(ca, cb) and za0 == zb0 and za1 == zb1
    with pytest.raises(ValueError, match="9K"):
        unpack_general_outputs(packed[:, :-1])


def test_finish_general_batch_matches_jax_on_one_packed_array():
    """The host tail alone: the same packed candidates (from JAX's device
    fit, rooms and random outputs, so the vectorized and the scalar paths
    both run) through both packages' tails, equal to the bit."""
    y_bon, y_cor = _rooms(11, 4)
    rng = np.random.default_rng(2)
    y_bon = np.concatenate([y_bon, np.stack(
        [rng.uniform(-0.9, -0.2, (2, W)), rng.uniform(0.2, 0.9, (2, W))],
        1).astype(np.float32)])
    y_cor = np.concatenate([y_cor, rng.uniform(0, 1, (2, W)).astype(
        np.float32)])
    packed = np.asarray(jax_pp.pack_general_outputs(
        jax_pp.postprocess_general_batch(jnp.asarray(y_bon),
                                         jnp.asarray(y_cor), H, W)))
    got = finish_general_batch(packed, W, H)
    want = jax_serving.finish_general_batch(packed, W, H)
    assert len(got) == len(want) == 6
    for (c, z0, z1), (cj, z0j, z1j) in zip(got, want):
        np.testing.assert_array_equal(c, cj)
        assert z0 == z0j and z1 == z1j
    # the scalar path alone, on a pano that takes it
    locs, fit, score, l1, mean, z1, cub = unpack_general_outputs(packed)
    from horizonnet_tpu_torch.postproc.serving import general_from_candidates
    c, _, _ = general_from_candidates(locs[5], fit[5], score[5], l1[5],
                                      mean[5], z1[5], cub[5], W, H)
    cj, _, _ = jax_serving.general_from_candidates(
        locs[5], fit[5], score[5], l1[5], mean[5], z1[5], cub[5], W, H)
    np.testing.assert_array_equal(c, cj)


def test_polygon_validity_copies_match_jax():
    from horizonnet_tpu.geometry import polygon as jax_poly
    from horizonnet_tpu_torch.geometry import polygon

    rng = np.random.default_rng(3)
    rings = rng.normal(0, 1, (40, 6, 2))
    rings[:5] = [[0, 0], [1, 0], [1, 1], [2, 1], [2, 2], [0, 2]]  # L-room
    rings[5] = 0.0                                             # no area
    got = polygon.polygon_is_valid_batch(rings)
    np.testing.assert_array_equal(got,
                                  jax_poly.polygon_is_valid_batch(rings))
    assert [polygon.polygon_is_valid(r) for r in rings] == list(got)
    assert got[:5].all() and not got[5]


def test_golden_general_through_the_engine():
    """The committed checkpoint on val_room in general mode, f32: within
    1 px of golden_outputs.npz's general_uv (the JAX bar,
    tests/test_golden_ckpt.py), z1 within 0.2."""
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model
    from horizonnet_tpu_torch.utils.image import read_png

    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    img = read_png(os.path.join(FIXDIR, "val_room.png"))[None]
    model, sd = load_trained_model(CKPT, device="cpu")
    eng = InferenceEngine(model, sd, postproc="general", device="cpu")
    packed = eng(img.astype(np.float32) / 255.0)
    assert packed.shape == (1, 9 * 32 + 17)
    (cor_id, z0, z1), = finish_general_batch(packed)
    assert cor_id.shape == want["general_uv"].shape
    dpx = np.abs(cor_id - want["general_uv"]).max() * 512
    assert dpx < 1.0, f"general corners {dpx:.3f} px off golden"
    assert z0 == 50.0 and abs(z1 - float(want["general_z1"])) < 0.2


def test_cli_general_on_cpu(tmp_path):
    """--device_postproc without --force_cuboid: the {z0, z1, uv} JSON of
    the golden, within 1 px of general_uv."""
    from horizonnet_tpu_torch.cli.inference import main

    want = np.load(os.path.join(FIXDIR, "golden_outputs.npz"))
    assert main(["--pth", CKPT, "--img_glob",
                 os.path.join(FIXDIR, "val_room.png"), "--output_dir",
                 str(tmp_path), "--device_postproc", "--device", "cpu"]) == 0
    with open(tmp_path / "val_room.json") as f:
        got = json.load(f)
    assert sorted(got) == ["uv", "z0", "z1"] and got["z0"] == 50.0
    dpx = np.abs(np.asarray(got["uv"]) - want["general_uv"]).max() * 512
    assert dpx < 1.0, f"CLI general corners {dpx:.3f} px off golden"
    assert abs(got["z1"] - float(want["general_z1"])) < 0.2
