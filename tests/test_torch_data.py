"""The port's training data (horizonnet_tpu_torch/data) against JAX.

Synthetic rooms, labels, augmentation parameters and corners are host
numpy on both sides and must agree exactly; the batched warp (uint8, dct
and dct4 wires) is float32 on both sides.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from horizonnet_tpu.data import augment as jax_aug
from horizonnet_tpu.data import labels as jax_labels
from horizonnet_tpu.data import synth as jax_synth
from horizonnet_tpu.data.dataset import PanoCorBonDataset as JaxDataset
from horizonnet_tpu.data.dataset import make_training_batch as jax_batch
from horizonnet_tpu.geometry.lines import cor_2_1d as jax_cor_2_1d
from horizonnet_tpu_torch.data import augment, labels, synth
from horizonnet_tpu_torch.data.dataset import (PanoCorBonDataset,
                                               make_training_batch)
from horizonnet_tpu_torch.geometry.lines import cor_2_1d
from horizonnet_tpu_torch.utils.image import write_png

H, W = 512, 1024


@pytest.fixture(scope="module")
def rooms():
    """Two synthetic rooms (one cuboid, one L-shaped) from the port's copy
    of the generator, which must give the JAX package's rooms."""
    out = []
    for seed, general_p in ((0, 0.0), (1, 1.0)):
        img, cor = synth.synth_room(np.random.default_rng(seed), H, W,
                                    general_p)
        img_j, cor_j = jax_synth.synth_room(np.random.default_rng(seed), H,
                                            W, general_p)
        np.testing.assert_array_equal(img, img_j)
        np.testing.assert_array_equal(cor, cor_j)
        out.append((img, cor))
    return out


def test_labels_match_jax(rooms):
    for _, cor in rooms:
        np.testing.assert_array_equal(cor_2_1d(cor, H, W),
                                      jax_cor_2_1d(cor, H, W))
        np.testing.assert_array_equal(
            labels.find_occlusion(cor[::2].copy(), W, H),
            jax_labels.find_occlusion(cor[::2].copy(), W, H))
        np.testing.assert_array_equal(labels.corner_heatmap(cor[::2, 0], W),
                                      jax_labels.corner_heatmap(cor[::2, 0],
                                                                W))
        assert labels.cor2xybound(cor, W) == jax_labels.cor2xybound(cor, W)
        np.testing.assert_array_equal(
            labels.stretched_corners(cor, 1.3, 0.7, W),
            jax_labels.stretched_corners(cor, 1.3, 0.7, W))


def test_aug_params_and_corners_match_jax(rooms):
    """Same numpy RNG, same draws in the same order."""
    rng, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        for _, cor in rooms:
            p = augment.sample_aug_params(rng, cor, W)
            assert p == jax_aug.sample_aug_params(rng_j, cor, W)
            np.testing.assert_array_equal(
                augment.transform_corners(cor, p, W),
                jax_aug.transform_corners(cor, p, W))


# The warp is float32 on both sides; the grid (trig of the stretch) and
# the bilinear weights round differently in the two frameworks: measured
# up to 4.0e-5 on values in [0, 1], so 2e-4 (a 255-level pixel step is
# 3.9e-3).
@pytest.mark.parametrize("wire", ["uint8", "dct", "dct4"])
def test_batched_warp_matches_jax(rooms, wire):
    imgs = np.stack([r[0] for r in rooms])
    kx = np.array([1.0, 1.6], np.float32)
    ky = np.array([1.3, 0.7], np.float32)
    flip = np.array([False, True])
    dx = np.array([0, 377], np.int32)
    gp = np.array([1.0, 0.6], np.float32)
    jargs = tuple(map(jnp.asarray, (kx, ky, flip, dx, gp)))
    targs = (torch.from_numpy(kx), torch.from_numpy(ky),
             torch.from_numpy(flip), torch.from_numpy(dx).long(),
             torch.from_numpy(gp))
    if wire == "uint8":
        want = jax_aug.batched_augment_images(jnp.asarray(imgs), *jargs)
        got = augment.augment_images(torch.from_numpy(imgs), *targs)
    else:
        from horizonnet_tpu_torch.ops import dct

        pack = dct.pack_dct if wire == "dct" else dct.pack_dct4
        packed = pack(imgs)
        unpack = dct.unpack_dct_to_rgb if wire == "dct" \
            else dct.unpack_dct4_to_rgb
        jfn = (jax_aug.batched_augment_images_dct if wire == "dct"
               else jax_aug.batched_augment_images_dct4)
        want = jfn(jnp.asarray(packed), H, W, *jargs)
        got = augment.augment_images(unpack(torch.from_numpy(packed), H, W),
                                     *targs)
    assert got.shape == (2, H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("wire", ["uint8", "dct", "dct4"])
def test_augment_batch_on_the_cpu_takes_no_copy_stream(rooms, wire):
    """On the CPU augment_batch counts no stream upload, and its output is
    augment_images on the plain tensors of its draws: the pixels (or their
    wire, decoded) and the five vectors torch.tensor makes."""
    from horizonnet_tpu_torch.ops import dct

    imgs = np.stack([r[0] for r in rooms])
    cors = [r[1] for r in rooms]
    n0 = augment.stream_uploads
    x, _, ps = augment.augment_batch(
        imgs, cors, np.random.default_rng(3), H, W, wire=wire, device="cpu",
        flip=True, rotate=True, gamma=True, stretch=True)
    assert augment.stream_uploads == n0

    def vec(k, dtype):
        return torch.tensor([p[k] for p in ps], dtype=dtype)

    rgb = torch.from_numpy(imgs)
    if wire == "dct":
        rgb = dct.unpack_dct_to_rgb(torch.from_numpy(dct.pack_dct(imgs)),
                                    H, W)
    elif wire == "dct4":
        rgb = dct.unpack_dct4_to_rgb(torch.from_numpy(dct.pack_dct4(imgs)),
                                     H, W)
    want = augment.augment_images(
        rgb, vec("kx", torch.float32), vec("ky", torch.float32),
        vec("flip", torch.bool), vec("dx", torch.int64),
        vec("p", torch.float32))
    assert torch.equal(x, want)


def test_make_training_batch_matches_jax(rooms, tmp_path):
    """A PNG dataset on disk, full augmentation, the same numpy seed:
    the same labels exactly and the same images to the warp's bar."""
    os.makedirs(tmp_path / "img")
    os.makedirs(tmp_path / "label_cor")
    for i, (img, cor) in enumerate(rooms):
        write_png(str(tmp_path / "img" / f"r{i}.png"), img)
        np.savetxt(tmp_path / "label_cor" / f"r{i}.txt", cor, fmt="%.3f")
    flags = dict(flip=True, rotate=True, gamma=True, stretch=True)
    ds = PanoCorBonDataset(str(tmp_path), **flags)
    ds_j = JaxDataset(str(tmp_path), **flags)
    assert ds.img_fnames == ds_j.img_fnames
    for a, b in zip(ds.load_raw(1)[:3], ds_j.load_raw(1)[:3]):
        np.testing.assert_array_equal(a, b)
    x, bon, y_cor = make_training_batch(ds, [1, 0], np.random.default_rng(9),
                                        device="cpu")
    x_j, bon_j, y_cor_j = jax_batch(ds_j, [1, 0], np.random.default_rng(9))
    np.testing.assert_array_equal(bon, bon_j)
    np.testing.assert_array_equal(y_cor, y_cor_j)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=2e-4)
