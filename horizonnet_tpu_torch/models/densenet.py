"""DenseNet encoder family with wrap-padded convs (NCHW).

Counterpart of horizonnet_tpu/models/densenet.py: densenet121/169/161/201,
the reference's ENCODER_DENSENET (model.py:22-24). Module names give
torchvision's state_dict keys under ``features.`` (``conv0``, ``norm0``,
``denseblock{i}.denselayer{j}.{norm1,conv1,norm2,conv2}``,
``transition{i}.{norm,conv}``, ``norm5``), with the reference's LR_PAD
``.1`` infix on the width-padded ``conv0`` and ``conv2``. The reference
taps children 4, 6, 8 and 11 of torchvision's ``features`` (model.py:
102-108): the raw outputs of dense blocks 1-3, before their transitions,
and ``relu(norm5(x))``. No memory-efficient checkpointing, as in JAX.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm2d, Conv2d, avg_pool_2x2, conv2d,
                     max_pool_same_as_torch)

DENSENET_SPECS = {
    # name: (growth_rate, block_config, num_init_features)
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
}
BN_SIZE = 4


class DenseLayer(nn.Module):
    """BN-ReLU-conv1x1 (to 4 x growth) then BN-ReLU-conv3x3 (to growth),
    concatenated onto the input."""

    def __init__(self, cin, growth, bn_momentum=0.1):
        super().__init__()
        mid = BN_SIZE * growth
        self.norm1 = BatchNorm2d(cin, momentum=bn_momentum)
        self.conv1 = Conv2d(cin, mid, 1, bias=False)
        self.norm2 = BatchNorm2d(mid, momentum=bn_momentum)
        self.conv2 = conv2d(mid, growth, 3, 1, 1)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return torch.cat([x, out], dim=1)


class _Transition(nn.Module):
    """BN-ReLU-conv1x1 halving the channels, then a 2x2 average pool."""

    def __init__(self, cin, bn_momentum=0.1):
        super().__init__()
        self.norm = BatchNorm2d(cin, momentum=bn_momentum)
        self.conv = Conv2d(cin, cin // 2, 1, bias=False)

    def forward(self, x):
        return avg_pool_2x2(self.conv(F.relu(self.norm(x))))


class DenseNetEncoder(nn.Module):
    """Returns 4 feature maps at strides 4/8/16/32. x: [B, 3, H, W].
    ``seam_pool`` wrap-pads the stem's max pool (exact seam
    equivariance); the default keeps torch's edge padding."""

    def __init__(self, backbone="densenet121", bn_momentum=0.1,
                 seam_pool=False):
        super().__init__()
        growth, blocks, n = DENSENET_SPECS[backbone]
        self.seam_pool = seam_pool
        f = nn.Module()
        f.conv0 = conv2d(3, n, 7, 2, 3)
        f.norm0 = BatchNorm2d(n, momentum=bn_momentum)
        for bi, n_layers in enumerate(blocks):
            block = nn.Sequential()
            for li in range(n_layers):
                block.add_module(f"denselayer{li + 1}", DenseLayer(
                    n + li * growth, growth, bn_momentum))
            setattr(f, f"denseblock{bi + 1}", block)
            n += n_layers * growth
            if bi < len(blocks) - 1:
                setattr(f, f"transition{bi + 1}",
                        _Transition(n, bn_momentum))
                n //= 2
        f.norm5 = BatchNorm2d(n, momentum=bn_momentum)
        self.features = f
        self.n_blocks = len(blocks)

    def forward(self, x):
        f = self.features
        x = F.relu(f.norm0(f.conv0(x)))
        x = max_pool_same_as_torch(x, 3, 2, 1, wrap_width=self.seam_pool)
        feats = []
        for bi in range(1, self.n_blocks + 1):
            x = getattr(f, f"denseblock{bi}")(x)
            if bi < self.n_blocks:
                feats.append(x)          # raw dense-block output
                x = getattr(f, f"transition{bi}")(x)
        feats.append(F.relu(f.norm5(x)))
        return feats


def densenet_feature_channels(backbone):
    """Channels of the 4 taps."""
    growth, blocks, n = DENSENET_SPECS[backbone]
    chans = []
    for bi, n_layers in enumerate(blocks):
        n += n_layers * growth
        if bi < len(blocks) - 1:
            chans.append(n)
            n //= 2
    chans.append(n)
    return tuple(chans)
