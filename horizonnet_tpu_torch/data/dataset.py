"""Dataset index, per-sample loading and batch assembly.

Counterpart of horizonnet_tpu/data/dataset.py (reference dataset.py:
13-134, PanoCorBonDataset). On disk: root/img/*.{png,jpg} and
root/label_cor/*.txt with interleaved ceiling/floor corner pixel coords.
PNGs decode with utils/image.py::read_png; other formats go through
Pillow, imported on that path only.

``make_training_batch`` samples the augmentation parameters on the host,
warps the images in one batched device pass (data/augment.py) and makes
the bon / corner-heatmap labels on the host from the transformed corners.
"""

import os

import numpy as np

from ..geometry.lines import cor_2_1d
from ..utils.image import read_png
from .augment import augment_batch
from .labels import corner_heatmap, find_occlusion


def _read_image(path):
    if path.endswith(".png"):
        return read_png(path)[..., :3]
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: images other than PNG need Pillow") \
            from e
    return np.asarray(Image.open(path), np.uint8)[..., :3]


class PanoCorBonDataset:
    def __init__(self, root_dir, flip=False, rotate=False, gamma=False,
                 stretch=False, p_base=0.96, max_stretch=2.0,
                 return_cor=False, return_path=False, wire="uint8"):
        self.img_dir = os.path.join(root_dir, "img")
        self.cor_dir = os.path.join(root_dir, "label_cor")
        self.img_fnames = sorted(
            f for f in os.listdir(self.img_dir)
            if f.endswith(".jpg") or f.endswith(".png"))
        self.txt_fnames = [f"{f[:-4]}.txt" for f in self.img_fnames]
        self.flip = flip
        self.rotate = rotate
        self.gamma = gamma
        self.stretch = stretch
        self.p_base = p_base
        self.max_stretch = max_stretch
        self.return_cor = return_cor
        self.return_path = return_path
        self.wire = wire  # "uint8" | "dct" | "dct4" batch upload (augment.py)
        for f in self.txt_fnames:
            path = os.path.join(self.cor_dir, f)
            if not os.path.isfile(path):
                raise FileNotFoundError(f"{path} not found")

    def __len__(self):
        return len(self.img_fnames)

    def load_raw(self, idx):
        """Raw sample: (img [H, W, 3] uint8, cor (2N, 2), occlusion mask,
        path). Images stay uint8 until they are on the device."""
        img_path = os.path.join(self.img_dir, self.img_fnames[idx])
        img = _read_image(img_path)
        H, W = img.shape[:2]

        with open(os.path.join(self.cor_dir, self.txt_fnames[idx])) as f:
            cor = np.array([line.strip().split() for line in f
                            if line.strip()], np.float32)
        # ring order starts at the corner with the smallest x (dataset.py:62)
        cor = np.roll(cor[:, :2], -2 * np.argmin(cor[::2, 0]), 0)
        # occlusion from the corners before augmentation, as the reference
        occlusion = find_occlusion(cor[::2].copy(), W, H).repeat(2)
        if (np.abs(cor[0::2, 0] - cor[1::2, 0]) > W / 100).any() \
                or (cor[0::2, 1] > cor[1::2, 1]).any():
            raise ValueError(f"{img_path}: corners are not ceiling/floor "
                             "pairs")
        return img, cor, occlusion, img_path

    def __getitem__(self, idx):
        """Un-augmented sample with labels (the validation path)."""
        img, cor, occlusion, path = self.load_raw(idx)
        H, W = img.shape[:2]
        bon = cor_2_1d(cor, H, W)
        y_cor = corner_heatmap(cor[~occlusion, 0], W, self.p_base)[None]
        out = [img.astype(np.float32) / 255.0, bon.astype(np.float32), y_cor]
        if self.return_cor:
            out.append(cor)
        if self.return_path:
            out.append(path)
        return out


def make_training_batch(dataset: PanoCorBonDataset, indices,
                        rng: np.random.Generator, *, device):
    """One augmented training batch: (x [B, H, W, 3] float32 on
    ``device``, bon [B, 2, W], y_cor [B, 1, W] numpy)."""
    imgs, cors, occs = [], [], []
    for i in indices:
        img, cor, occ, _ = dataset.load_raw(i)
        imgs.append(img)
        cors.append(cor)
        occs.append(occ)
    imgs = np.stack(imgs)
    B, H, W, _ = imgs.shape

    x, aug_cors, _ = augment_batch(
        imgs, cors, rng, H, W, wire=dataset.wire, device=device,
        flip=dataset.flip, rotate=dataset.rotate, gamma=dataset.gamma,
        stretch=dataset.stretch, max_stretch=dataset.max_stretch)

    bons = np.stack([cor_2_1d(c, H, W) for c in aug_cors]).astype(np.float32)
    y_cors = np.stack([
        corner_heatmap(c[~occ, 0], W, dataset.p_base)[None]
        for c, occ in zip(aug_cors, occs)])
    return x, bons, y_cors
