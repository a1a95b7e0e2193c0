"""Seam-free bilinear width resize (torch align_corners=False).

Counterpart of horizonnet_tpu/ops/resize.py::wrap_resize_width, which
folds the same pad + resize + trim into one matrix (tests/test_ops.py
pins it to this form): the reference's GlobalHeightConv tail,
model.py:151-156.
"""

import torch.nn.functional as F

from .pad import wrap_pad_width


def wrap_resize_width(x, out_w: int):
    """x [B, C, H, W] -> [B, C, H, out_w]: wrap-pad one column each side,
    resize the width to out_w + 2*factor, trim factor columns each side.
    Requires out_w % W == 0."""
    in_w = x.shape[-1]
    if out_w % in_w:
        raise ValueError(f"out_w {out_w} is not a multiple of width {in_w}")
    factor = out_w // in_w
    x = wrap_pad_width(x, 1, dim=-1)
    x = F.interpolate(x, size=(x.shape[-2], out_w + 2 * factor),
                      mode="bilinear", align_corners=False)
    return x[..., factor:-factor]
