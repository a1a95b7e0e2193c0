"""Seam-free bilinear width resize (torch align_corners=False).

Counterpart of horizonnet_tpu/ops/resize.py::wrap_resize_width: the
reference's GlobalHeightConv tail (model.py:151-156), a one-column wrap pad,
a bilinear resize of the width to out_w + 2*factor and a trim of factor
columns each side, folded into one constant [W, out_w] matrix as the JAX
package folds it (tests/test_ops.py pins that matrix to F.interpolate).

A product with the matrix, where F.interpolate would resize: its backward
is a product too, where F.interpolate's backward on CUDA adds into the
input gradient with atomics, in an order that changes from run to run. So
a train step on the card is bit-reproducible, and a captured step equals
the eager one bit for bit (train/engine.py). The product runs in float32,
so that for a bfloat16 input each output is the two exact products summed
in float32 and rounded once, as F.interpolate forms it (a bfloat16 product
may reduce in bfloat16 on the card).
"""

import functools

import numpy as np
import torch


def _interp_matrix(in_w, out_w):
    """[in_w, out_w] matrix M with out = x @ M (torch align_corners=False)."""
    coords = (np.arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    coords = np.clip(coords, 0.0, in_w - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_w - 1)
    w = coords - lo
    M = np.zeros((in_w, out_w), np.float32)
    cols = np.arange(out_w)
    np.add.at(M, (lo, cols), 1.0 - w)
    np.add.at(M, (hi, cols), w)
    return M


@functools.lru_cache(maxsize=None)
def wrap_resize_matrix(in_w, out_w, device):
    """The [in_w, out_w] float32 matrix of wrap_resize_width on ``device``
    (its weights are multiples of 1 / (2 factor)). Cached: made once per
    shape, outside any captured program that uses it."""
    factor = out_w // in_w
    M = _interp_matrix(in_w + 2, out_w + 2 * factor)[:, factor:-factor]
    # the wrap pad folded into the rows: padded row 0 is the last input
    # column, padded row in_w + 1 the first
    fold = M[1:in_w + 1].copy()
    fold[in_w - 1] += M[0]
    fold[0] += M[in_w + 1]
    return torch.from_numpy(fold).to(device)


def wrap_resize_width(x, out_w: int):
    """x [B, C, H, W] -> [B, C, H, out_w]: wrap-pad one column each side,
    resize the width to out_w + 2*factor, trim factor columns each side.
    Requires out_w % W == 0."""
    in_w = x.shape[-1]
    if out_w % in_w:
        raise ValueError(f"out_w {out_w} is not a multiple of width {in_w}")
    M = wrap_resize_matrix(in_w, out_w, x.device)
    return (x.float() @ M).to(x.dtype)
