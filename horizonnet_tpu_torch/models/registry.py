"""Backbone registry and model construction (reference model.py:18-24).

Counterpart of horizonnet_tpu/models/registry.py: the resnet and
densenet encoder families, under HorizonNet's heads or (``arch="lgt"``,
the port's own) LGT-Net's SWG-Transformer (models/lgt.py).
"""

import torch

from .horizonnet import HorizonNet
from .lgt import LGTNet

ARCHS = ("horizonnet", "lgt")

ENCODER_RESNET = [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d",
]
ENCODER_DENSENET = [
    "densenet121", "densenet169", "densenet161", "densenet201",
]


def build_model(backbone="resnet50", use_rnn=True, *, device,
                dtype=torch.float32, lstm_impl="kernel", seed=0,
                param_dtype=None, bn_momentum=0.1, fused_blocks="",
                seam_pool=False, quant_int8=False,
                s2d_stem=False, arch="horizonnet", W=1024):
    """A HorizonNet on ``device`` in eval mode, random from ``seed``.
    A training model passes ``param_dtype=torch.float32`` (f32 weights,
    ``dtype`` compute). ``fused_blocks="kernel"`` serves the resnet
    bottlenecks' identity blocks fused (K4, ops/fused_block.py).
    ``seam_pool`` wrap-pads the stem's max pool; ``quant_int8`` builds
    the serving-only int8 resnet encoder, which loads the state_dict of
    models/quant.py::quantize_state_dict. ``s2d_stem`` runs the standard
    stem, the same math as the JAX package's space-to-depth stem; it is
    taken only to refuse it beside ``quant_int8``, as JAX does. Raises
    the JAX package's ValueErrors (horizonnet_tpu/models/registry.py:
    24-31).

    ``arch="lgt"`` builds LGT-Net (models/lgt.py) for input width ``W``
    on the same encoders; ``use_rnn`` and ``lstm_impl`` do not apply to
    it, and it takes neither the fused, the int8 nor the s2d options."""
    if backbone not in ENCODER_RESNET + ENCODER_DENSENET:
        raise ValueError(f"unknown backbone {backbone!r}")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; one of {ARCHS}")
    if arch == "lgt":
        if fused_blocks or quant_int8 or s2d_stem:
            raise ValueError("LGT-Net trains the float encoder unfused: no "
                             "fused_blocks, quant_int8 or s2d_stem")
        return LGTNet(backbone, W, device=device, dtype=dtype, seed=seed,
                      param_dtype=param_dtype, bn_momentum=bn_momentum,
                      seam_pool=seam_pool)
    if quant_int8 and s2d_stem:
        raise ValueError("quant_int8 and s2d_stem are mutually exclusive "
                         "(the quant stem is the plain 7x7 path)")
    if fused_blocks and backbone not in ENCODER_RESNET:
        raise ValueError("fused_blocks covers the resnet bottleneck family "
                         "(ops/fused_block.py)")
    return HorizonNet(backbone, use_rnn, device=device, dtype=dtype,
                      lstm_impl=lstm_impl, seed=seed,
                      param_dtype=param_dtype, bn_momentum=bn_momentum,
                      fused_blocks=fused_blocks, seam_pool=seam_pool,
                      quant_int8=quant_int8)
