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
"""

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, conv2d, max_pool_same_as_torch


def _downsample(cin, cout, stride, bn_momentum):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False),
                         BatchNorm2d(cout, momentum=bn_momentum))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64, bn_momentum=0.1):
        super().__init__()
        self.conv1 = conv2d(cin, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes, momentum=bn_momentum)
        self.conv2 = conv2d(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes, momentum=bn_momentum)
        self.downsample = (_downsample(cin, planes, stride, bn_momentum)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64, bn_momentum=0.1, fused=""):
        super().__init__()
        if fused not in ("", "kernel"):
            raise ValueError(f"unknown fused block mode {fused!r}")
        self.stride, self.groups, self.fused = stride, groups, fused
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv2d(cin, width, 1)
        self.bn1 = BatchNorm2d(width, momentum=bn_momentum)
        self.conv2 = conv2d(width, width, 3, stride, 1, groups=groups)
        self.bn2 = BatchNorm2d(width, momentum=bn_momentum)
        self.conv3 = conv2d(width, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4, momentum=bn_momentum)
        self.downsample = (_downsample(cin, planes * 4, stride, bn_momentum)
                           if downsample else None)

    def forward(self, x):
        if (self.fused and not self.training and self.stride == 1
                and self.downsample is None and self.groups == 1):
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
                 fused_blocks=""):
        super().__init__()
        block, layers, groups, base_width = RESNET_SPECS[backbone]
        self.conv1 = conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64, momentum=bn_momentum)
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
                                             fused_blocks))
                else:
                    need_ds = bi == 0 and s != 1
                    blocks.append(BasicBlock(cin, planes, s, need_ds, groups,
                                             base_width, bn_momentum))
                cin = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_same_as_torch(x, 3, 2, 1)
        feats = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


def resnet_feature_channels(backbone):
    block = RESNET_SPECS[backbone][0]
    return tuple(c * block.expansion for c in (64, 128, 256, 512))
