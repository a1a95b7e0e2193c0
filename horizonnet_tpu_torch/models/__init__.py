"""HorizonNet model family of the port (resnet and densenet encoders)."""

from .horizonnet import HorizonNet
from .registry import build_model

__all__ = ["HorizonNet", "build_model"]
