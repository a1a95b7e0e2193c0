"""Dropout in the JAX package's form, with masks from an explicit generator.

flax's nn.Dropout and horizonnet_tpu/ops/lstm.py:142-145 keep each entry
with probability 1 - rate and scale the kept ones: ``where(keep,
x / (1 - rate), 0)``. Every dropout mask of the port is drawn by
``keep_mask``, from the ``torch.Generator`` the caller passes, so a run is
reproducible from its seeds and a test can put its own masks in.
"""

import torch


def keep_mask(shape, keep_prob, generator, device):
    """Bool tensor of ``shape`` on ``device``: True with ``keep_prob``."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x, rate, generator):
    """where(keep, x / (1 - rate), 0) with keep from ``keep_mask``."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator (train-mode "
                         "forward takes one)")
    keep = keep_mask(x.shape, 1.0 - rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
