"""Raw model-output visualization strip (reference dataset.py:211-229).

Copy of horizonnet_tpu/viewer/visualize.py. Layout: a 30-row
corner-probability heatmap, a 3-row white separator, then the pano at
half brightness with the ceiling and floor boundaries in green.
"""

import numpy as np


def visualize_a_data(x, y_bon, y_cor):
    """x: [H, W, 3] float in [0, 1]; y_bon: [2, W] radians; y_cor: [W]
    probabilities. Returns a uint8 image [(33 + H), W, 3]."""
    x = np.asarray(x)
    H, W = x.shape[:2]
    img = (x * 255).astype(np.uint8)
    y_bon = np.asarray(y_bon)
    rows = ((y_bon / np.pi + 0.5) * H).round().astype(int)
    rows = np.clip(rows, 0, H - 1)
    y_cor = np.asarray(y_cor).reshape(-1)

    gt_cor = np.zeros((30, W, 3), np.uint8)
    gt_cor[:] = (np.clip(y_cor, 0, 1)[None, :, None] * 255).astype(np.uint8)
    pad = np.full((3, W, 3), 255, np.uint8)

    img_bon = (img * 0.5).astype(np.uint8)
    cols = np.arange(W)
    img_bon[rows[0], cols, 1] = 255
    img_bon[rows[1], cols, 1] = 255
    return np.concatenate([gt_cor, pad, img_bon], 0)
