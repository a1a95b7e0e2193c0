"""Height-compression stage: 4 multi-scale maps -> per-column feature.

Counterpart of horizonnet_tpu/models/height.py (reference model.py:
123-179): each encoder map passes through 4x [Conv k3 stride (2,1) + BN +
ReLU] with channel schedule c -> c/2 -> c/2 -> c/4 -> c/out_scale, is
wrap-resized to out_w columns, flattened channel-major then height, and
the 4 scales are concatenated into [B, c_last, out_w]. Attribute names
give the reference's keys (``ghc_lst.{i}.layer.{j}.layers.{0,1}``).
"""

import torch
import torch.nn as nn

from .layers import BatchNorm2d, conv2d
from ..ops.resize import wrap_resize_width


class ConvCompressH(nn.Module):
    """Conv k3 stride (2,1) + BN + ReLU: halves height, keeps width."""

    def __init__(self, in_c, out_c, ks=3, bn_momentum=0.1):
        super().__init__()
        if ks % 2 != 1:
            raise ValueError(f"kernel size {ks} must be odd")
        self.layers = nn.Sequential(
            conv2d(in_c, out_c, ks, (2, 1), ks // 2, bias=True),
            BatchNorm2d(out_c, momentum=bn_momentum), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.layers(x)


class GlobalHeightConv(nn.Module):
    """4x height halving, then the seam-free width resize to out_w."""

    def __init__(self, in_c, out_c, bn_momentum=0.1):
        super().__init__()
        m = bn_momentum
        self.layer = nn.Sequential(
            ConvCompressH(in_c, in_c // 2, bn_momentum=m),
            ConvCompressH(in_c // 2, in_c // 2, bn_momentum=m),
            ConvCompressH(in_c // 2, in_c // 4, bn_momentum=m),
            ConvCompressH(in_c // 4, out_c, bn_momentum=m))

    def forward(self, x, out_w):
        return wrap_resize_width(self.layer(x), out_w)   # [B, C, H', out_w]


class GlobalHeightStage(nn.Module):
    """Fuse the 4 encoder scales into one [B, c_last, out_w] feature."""

    def __init__(self, channels, out_scale=8, bn_momentum=0.1):
        super().__init__()
        self.ghc_lst = nn.ModuleList(
            [GlobalHeightConv(c, c // out_scale, bn_momentum)
             for c in channels])

    def forward(self, feats, out_w):
        if len(feats) != len(self.ghc_lst):
            raise ValueError(f"{len(feats)} feature maps for "
                             f"{len(self.ghc_lst)} stages")
        bs = feats[0].shape[0]
        return torch.cat([ghc(f, out_w).reshape(bs, -1, out_w)
                          for ghc, f in zip(self.ghc_lst, feats)], dim=1)
