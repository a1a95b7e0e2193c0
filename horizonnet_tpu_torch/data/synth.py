"""Synthetic textured room panos with exact corner ground truth.

Copy of horizonnet_tpu/data/synth.py: the same numpy RNG calls, so one
seed gives the same rooms in both packages.

The image ships no training dataset (the reference's PanoContext/ST3D
data lives outside the repo), so reproducible training artifacts — the
committed golden checkpoint (tools/train_golden.py), throughput runs,
smoke tests — need a generator that produces (pano, corner-GT) pairs
with the exact label geometry of PanoCorBonDataset (ref dataset.py).

Rooms are cuboid or L-shaped plans seen from an interior camera; the
per-column ceiling/floor boundary comes from the same great-circle
tracing as the training labels (geometry/lines.py cor_2_1d), and the
render paints ceiling/floor/walls with distinct shaded bands, per-wall
brightness, and darkened corner columns — enough visual structure that a
small network learns boundaries and corners from a few hundred steps.
"""

import numpy as np

from ..geometry.equirect_host import infer_coory, xy2coor
from ..geometry.lines import cor_2_1d


def synth_plan(rng, general_p=0.5):
    """Random room plan (plan-view pixel coords around the pano center)."""
    cx, cy = 512 - 0.5, 256 - 0.5
    w1, d1 = rng.uniform(5, 11), rng.uniform(4, 9)
    if rng.uniform() < general_p:
        wq = rng.uniform(1.5, w1 - 1.5)
        dq = rng.uniform(1.5, d1 - 1.5)
        plan = np.array([
            [cx - w1, cy - d1], [cx + w1, cy - d1], [cx + w1, cy + dq],
            [cx + wq, cy + dq], [cx + wq, cy + d1], [cx - w1, cy + d1]])
    else:
        plan = np.array([[cx - w1, cy - d1], [cx + w1, cy - d1],
                         [cx + w1, cy + d1], [cx - w1, cy + d1]])
    return plan


def synth_room(rng, H=512, W=1024, general_p=0.5):
    """One synthetic pano. Returns (img uint8 [H, W, 3], cor [N, 2]).

    ``cor`` is the GT corner list in pixel coords, ceiling/floor
    interleaved and ordered by x — the label_cor txt format of the
    reference datasets (README_PREPARE_DATASET.md layout).
    """
    plan = synth_plan(rng, general_p)
    z0 = 50.0
    z1 = -rng.uniform(30, 75)  # floor plane (demo room sits near -47)
    ceil = xy2coor(plan, z0, W, H)
    ceil = ceil[np.argsort(ceil[:, 0])]
    floor_y = infer_coory(ceil[:, 1], z1 - z0, z0, H)
    n = len(ceil)
    cor = np.empty((2 * n, 2), np.float32)
    cor[0::2] = ceil
    cor[1::2] = np.stack([ceil[:, 0], floor_y], -1)

    bon = cor_2_1d(cor, H, W)                     # [2, W] radians
    rows = ((bon / np.pi + 0.5) * H - 0.5)        # pixel rows
    ceil_row, floor_row = rows[0], rows[1]

    ys = np.arange(H)[:, None]
    above = ys < ceil_row[None, :]
    below = ys > floor_row[None, :]
    wall = ~(above | below)

    # Distinct, randomly colored bands with smooth shading gradients
    base = rng.uniform(60, 200, (3, 3))           # ceil / wall / floor
    img = np.zeros((H, W, 3))
    grad_v = np.linspace(0.75, 1.25, H)[:, None]
    img += above[..., None] * base[0] * grad_v[..., None]
    img += below[..., None] * base[2] * (2 - grad_v)[..., None]

    # Per-wall brightness from the segment id of each column
    seg = (np.arange(W)[:, None] >= ceil[:, 0][None, :]).sum(1) % n
    wall_gain = rng.uniform(0.6, 1.4, n)[seg][None, :, None]
    img += wall[..., None] * base[1] * wall_gain

    # Darkened corner columns (3 px) make the corner channel learnable
    for x in np.round(ceil[:, 0]).astype(int):
        sl = (np.arange(x - 1, x + 2) % W)
        img[:, sl] *= np.where(wall[:, sl, None], 0.45, 1.0)

    img += rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), cor


def synth_batch(rng, n, H=512, W=1024, general_p=0.5):
    """n rooms -> (imgs [n, H, W, 3] uint8, y_bon [n, 2, W],
    y_cor [n, 1, W], cors list) with training targets synthesized the
    dataset way (data/labels.py corner heatmap semantics)."""
    from .labels import corner_heatmap

    imgs, bons, heats, cors = [], [], [], []
    for _ in range(n):
        img, cor = synth_room(rng, H, W, general_p)
        imgs.append(img)
        bons.append(cor_2_1d(cor, H, W))
        heats.append(corner_heatmap(cor[0::2, 0], W))
        cors.append(cor)
    return (np.stack(imgs), np.stack(bons).astype(np.float32),
            np.stack(heats)[:, None].astype(np.float32), cors)
