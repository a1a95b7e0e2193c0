"""Horizontal wrap padding: the equirectangular seam is periodic.

Counterpart of horizonnet_tpu/ops/pad.py: ``wrap_pad_width`` (the
reference's lr_pad, model.py:27-29) and ``seam_layout``, the geometry of
models/layers.py::WrapConv's ``seam_fix`` path, which pads nothing.
"""

import torch


def wrap_pad_width(x, pad: int, dim: int = -1):
    """Circularly pad ``x`` along ``dim`` by ``pad`` on each side: the left
    pad is a copy of the rightmost columns and vice versa."""
    if pad == 0:
        return x
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, n - pad, pad), x, x.narrow(dim, 0, pad)],
                     dim=dim)


def seam_layout(W: int, kw: int, sw: int, pw: int):
    """Geometry of the seam-correction strip for a width-wrapped conv
    (copied from horizonnet_tpu/ops/pad.py::seam_layout).

    For a conv of kernel width ``kw``, width stride ``sw`` and symmetric
    wrap padding ``pw`` over input width ``W``, the zero-padded conv
    already gives the right output everywhere except the output columns
    whose window crosses the seam. Those are exactly the outputs of one
    unpadded conv over the wrapped strip ``cat(x[..., W-a:], x[..., :b])``,
    in the order [right-edge columns..., left-edge columns...].

    Returns (n_left, n_right, a, b), or None when the preconditions do not
    hold (the caller then takes the materialized wrap pad):
    - pw == (kw-1)/2 (odd kernel, torch-style symmetric padding), and
    - W % sw == 0, so the strip's stride phase continues the main conv's.
    """
    if pw <= 0 or kw % 2 == 0 or 2 * pw != kw - 1 or W % sw != 0:
        return None
    w_out = (W + 2 * pw - kw) // sw + 1
    if w_out * sw != W:
        return None
    n_left = -(-pw // sw)                       # ceil(pw / sw)
    j_r0 = (W - kw + pw) // sw + 1              # first seam-crossing right col
    n_right = w_out - j_r0
    a = W - (j_r0 * sw - pw)                    # right-end input cols
    b = (n_left - 1) * sw - pw + kw             # wrapped left input cols
    if n_left + n_right >= w_out or a > W or b > W or a < 0 or b < 0:
        return None
    assert a + b == (n_left + n_right - 1) * sw + kw, (a, b, n_left, n_right)
    return n_left, n_right, a, b
