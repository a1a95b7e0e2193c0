"""Backbone registry and model construction (reference model.py:18-24).

Counterpart of horizonnet_tpu/models/registry.py for the resnet family;
the densenet encoders are ROADMAP Queue 1 item 7.
"""

import torch

from .horizonnet import HorizonNet

ENCODER_RESNET = [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d",
]
ENCODER_DENSENET = [
    "densenet121", "densenet169", "densenet161", "densenet201",
]


def build_model(backbone="resnet50", use_rnn=True, *, device,
                dtype=torch.float32, lstm_impl="kernel",
                seed=0) -> HorizonNet:
    """A HorizonNet on ``device`` in eval mode, random from ``seed``."""
    if backbone in ENCODER_DENSENET:
        raise NotImplementedError(
            f"{backbone}: the densenet encoders are ROADMAP Queue 1 item 7")
    if backbone not in ENCODER_RESNET:
        raise ValueError(f"unknown backbone {backbone!r}")
    return HorizonNet(backbone, use_rnn, device=device, dtype=dtype,
                      lstm_impl=lstm_impl, seed=seed)
