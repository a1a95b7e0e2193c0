"""HorizonNet model family of the port (resnet and densenet encoders),
and LGT-Net on the same encoders."""

from .horizonnet import HorizonNet
from .lgt import LGTNet
from .registry import build_model

__all__ = ["HorizonNet", "LGTNet", "build_model"]
