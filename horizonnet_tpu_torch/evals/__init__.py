"""Evaluation metrics of the port (host numpy): cuboid (CE, PE, 3DIoU)
and general layouts (2D and 3D IoU, depth rmse, delta_1). Polygon and
polytope geometry come from horizonnet_tpu_torch.geometry."""

from .cuboid import eval_3diou, prepare_gtdt_pairs, test_cuboid
from .general import new_general_losses, summarize_general, test_general

__all__ = ["test_general", "new_general_losses", "summarize_general",
           "test_cuboid", "eval_3diou", "prepare_gtdt_pairs"]
