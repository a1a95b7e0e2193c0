"""HorizonNet model family of the port (resnet encoders)."""

from .horizonnet import HorizonNet
from .registry import build_model

__all__ = ["HorizonNet", "build_model"]
