"""ResNet / ResNeXt encoder family with wrap-padded convs (NCHW).

Counterpart of horizonnet_tpu/models/resnet.py: resnet18/34/50/101/152,
resnext50_32x4d, resnext101_32x8d (reference model.py:18-21), torchvision
v1.5 layout (stride on the 3x3 conv of bottlenecks). Attribute names give
torchvision's state_dict keys. Forward returns the 4 feature maps at
strides 4/8/16/32 (model.py:71-82).
"""

import torch.nn as nn
import torch.nn.functional as F

from .layers import conv2d, max_pool_same_as_torch


def _downsample(cin, cout, stride):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64):
        super().__init__()
        self.conv1 = conv2d(cin, planes, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride) if downsample
                           else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv2d(cin, width, 1)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = conv2d(width, width, 3, stride, 1, groups=groups)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = conv2d(width, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (_downsample(cin, planes * 4, stride) if downsample
                           else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


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

    def __init__(self, backbone="resnet50"):
        super().__init__()
        block, layers, groups, base_width = RESNET_SPECS[backbone]
        self.conv1 = conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        cin, planes = 64, 64
        for li, n_blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                if block is Bottleneck:
                    need_ds = bi == 0 and (s != 1 or li == 0)
                else:
                    need_ds = bi == 0 and s != 1
                blocks.append(block(cin, planes, s, need_ds, groups,
                                    base_width))
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
