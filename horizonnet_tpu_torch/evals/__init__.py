"""Evaluation metrics of the port (host numpy): the general-layout 2D and
3D IoU, depth rmse and delta_1. The cuboid metrics are ROADMAP Queue 1
item 11."""

from .general import new_general_losses, summarize_general, test_general

__all__ = ["new_general_losses", "summarize_general", "test_general"]
