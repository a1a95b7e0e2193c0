"""Shared layers: wrap-padded conv, batch norm, max pool (NCHW).

Counterpart of horizonnet_tpu/models/layers.py. The reference wraps every
width-padded Conv2d in ``Sequential(LR_PAD, conv)`` (model.py:27-55), which
puts a ``.1`` into those parameters' state_dict keys; WrapConv keeps that
layout, so a reference state_dict loads with ``load_state_dict``. Max
pooling keeps torch's -inf edge padding (the reference does not wrap it).
"""

import torch.nn as nn
import torch.nn.functional as F

from ..ops.pad import wrap_pad_width


class WrapPad(nn.Module):
    """Circular pad of the width (dim 3) by ``pad`` columns each side."""

    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return wrap_pad_width(x, self.pad, dim=3)


class WrapConv(nn.Sequential):
    """Conv2d with zero padding on H and circular padding on W.

    The default path of the JAX WrapConv (no seam_fix): materialize the
    circular pad, then a conv with height padding only. Children are
    ``0`` (the pad) and ``1`` (the conv), as in the reference.
    """

    def __init__(self, cin, cout, kernel_size, stride=1, padding=(0, 0),
                 bias=False, groups=1):
        ph, pw = padding
        super().__init__(WrapPad(pw), nn.Conv2d(
            cin, cout, kernel_size, stride, padding=(ph, 0), bias=bias,
            groups=groups))


def conv2d(cin, cout, kernel_size, stride=1, padding=0, bias=False,
           groups=1):
    """WrapConv when the width is padded, else a plain nn.Conv2d (the
    reference wraps only width-padded convs)."""
    if padding == 0:
        return nn.Conv2d(cin, cout, kernel_size, stride, bias=bias,
                         groups=groups)
    return WrapConv(cin, cout, kernel_size, stride, (padding, padding), bias,
                    groups)


def max_pool_same_as_torch(x, window=3, stride=2, padding=1):
    """torch MaxPool2d(window, stride, padding): pads with -inf."""
    return F.max_pool2d(x, window, stride, padding)
