"""Horizontal wrap padding: the equirectangular seam is periodic.

Counterpart of horizonnet_tpu/ops/pad.py::wrap_pad_width (the reference's
lr_pad, model.py:27-29).
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
