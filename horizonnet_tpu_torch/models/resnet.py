"""ResNet / ResNeXt encoder family with wrap-padded convs (NCHW).

Counterpart of horizonnet_tpu/models/resnet.py: resnet18/34/50/101/152,
resnext50_32x4d, resnext101_32x8d (reference model.py:18-21), torchvision
v1.5 layout (stride on the 3x3 conv of bottlenecks). Attribute names give
torchvision's state_dict keys. Forward returns the 4 feature maps at
strides 4/8/16/32 (model.py:71-82). ``bn_momentum`` is every batch norm's
running-stat momentum (torch's meaning, the CLI's --bn_momentum).

``fused_blocks="kernel"`` runs every identity bottleneck (stride 1, no
downsample, groups 1) in eval mode as one fused block
(ops/fused_block.py, K4), as the JAX package does with
``fused_blocks="pallas"``; the parameters, and so the state_dict keys,
are the same fused or not.

``quant=True`` is the serving-only int8 encoder (JAX ``resnet.py:23-40``):
every Conv+BN pair is one models/layers.py::QuantConvBN under the conv's
name (stem, ``conv1-3``, ``downsample.0``), its batch norm folded in and
gone (an ``nn.Identity`` in its place holds no state);
models/quant.py::quantize_state_dict makes its state_dict from a float
one. The fused blocks are not taken under quant, as in JAX.
``seam_pool`` wrap-pads the stem's max pool.
"""

import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm2d, Conv2d, QuantConvBN, conv2d,
                     max_pool_same_as_torch)


def _conv_bn(cin, cout, k, stride=1, padding=0, groups=1, bn_momentum=0.1,
             quant=False):
    """(conv, bn) of one Conv+BN unit: float, or (QuantConvBN,
    nn.Identity) under quant."""
    if quant:
        return (QuantConvBN(cin, cout, k, stride, (padding, padding),
                            groups), nn.Identity())
    return (conv2d(cin, cout, k, stride, padding, groups=groups),
            BatchNorm2d(cout, momentum=bn_momentum))


def _downsample(cin, cout, stride, bn_momentum, quant):
    if quant:
        return nn.Sequential(QuantConvBN(cin, cout, 1, stride))
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False),
                         BatchNorm2d(cout, momentum=bn_momentum))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64, bn_momentum=0.1, quant=False):
        super().__init__()
        m = bn_momentum
        self.conv1, self.bn1 = _conv_bn(cin, planes, 3, stride, 1,
                                        bn_momentum=m, quant=quant)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, 1, 1,
                                        bn_momentum=m, quant=quant)
        self.downsample = (_downsample(cin, planes, stride, m, quant)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64, bn_momentum=0.1, fused="", quant=False):
        super().__init__()
        if fused not in ("", "kernel"):
            raise ValueError(f"unknown fused block mode {fused!r}")
        self.stride, self.groups, self.fused = stride, groups, fused
        self.quant = quant
        width = int(planes * (base_width / 64.0)) * groups
        m = bn_momentum
        self.conv1, self.bn1 = _conv_bn(cin, width, 1, bn_momentum=m,
                                        quant=quant)
        self.conv2, self.bn2 = _conv_bn(width, width, 3, stride, 1, groups,
                                        m, quant)
        self.conv3, self.bn3 = _conv_bn(width, planes * 4, 1, bn_momentum=m,
                                        quant=quant)
        self.downsample = (_downsample(cin, planes * 4, stride, m, quant)
                           if downsample else None)

    def forward(self, x):
        if (self.fused and not self.training and self.stride == 1
                and self.downsample is None and self.groups == 1
                and not self.quant):
            return self._fused_forward(x)
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)

    def _fused_forward(self, x):
        """The whole block as one fused block (ops/fused_block.py): the
        three eval-mode batch norms are folded into the conv weights per
        call, as the JAX module does under jit. x is NCHW channels_last,
        so its NHWC permute is contiguous; so is the result's."""
        from ..ops.fused_block import fold_conv_bn, fused_bottleneck

        folded = []
        for conv, bn in ((self.conv1, self.bn1), (self.conv2[1], self.bn2),
                         (self.conv3, self.bn3)):
            folded += fold_conv_bn(conv.weight.permute(2, 3, 1, 0),
                                   bn.weight, bn.bias, bn.running_mean,
                                   bn.running_var, bn.eps)
        w1, b1, w2, b2, w3, b3 = folded
        y = fused_bottleneck(x.permute(0, 2, 3, 1), w1[0, 0], b1, w2, b2,
                             w3[0, 0], b3)
        return y.permute(0, 3, 1, 2)


RESNET_SPECS = {
    # name: (block, layers, groups, base_width)
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
}


class ResNetEncoder(nn.Module):
    """Returns 4 feature maps at strides 4/8/16/32. x: [B, 3, H, W]."""

    def __init__(self, backbone="resnet50", bn_momentum=0.1,
                 fused_blocks="", seam_pool=False, quant=False):
        super().__init__()
        block, layers, groups, base_width = RESNET_SPECS[backbone]
        self.seam_pool = seam_pool
        self.conv1, self.bn1 = _conv_bn(3, 64, 7, 2, 3,
                                        bn_momentum=bn_momentum, quant=quant)
        cin, planes = 64, 64
        for li, n_blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                if block is Bottleneck:
                    need_ds = bi == 0 and (s != 1 or li == 0)
                    blocks.append(Bottleneck(cin, planes, s, need_ds, groups,
                                             base_width, bn_momentum,
                                             fused_blocks, quant))
                else:
                    need_ds = bi == 0 and s != 1
                    blocks.append(BasicBlock(cin, planes, s, need_ds, groups,
                                             base_width, bn_momentum, quant))
                cin = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_same_as_torch(x, 3, 2, 1, wrap_width=self.seam_pool)
        feats = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


def resnet_feature_channels(backbone):
    block = RESNET_SPECS[backbone][0]
    return tuple(c * block.expansion for c in (64, 128, 256, 512))
